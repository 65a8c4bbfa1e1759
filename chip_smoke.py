#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``endosr_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Takes no arguments and runs every phase (any failure raises and the script
exits non-zero):

1. device — the card's name and power limit; TF32 off for fp32 checks.
2. build — every kernel under ``endosr_torch/csrc`` with one ``nvcc`` per
   source, all started together, into ``build/endosr_torch/``; ``ptxas``'s
   registers, spills and static shared memory of every kernel are logged,
   those of the ``wgmma`` conv (in ``head_dot``, ``fused_tail`` and
   ``packed_chain``), ``fused_mod_wgmma``, ``style_dot_tc``,
   ``style_blend_tc`` and the ``vec16`` kernels of ``in_stats``,
   ``fused_in_mod`` and the output stages on lines of their own.
3. kernels — each of the twelve kernels against its plain PyTorch version
   at the shapes the full-width forwards give it, in bf16 (max|Δ|/max|ref|
   ≤ 1e-2) and fp32 (≤ 1e-5 against float64); ``in_stats`` ≤ 1e-5 against
   float64 sums in both; ``output_stage_x8`` (the ×8 HBWC and the ×4 BHWC
   shape), ``output_stage`` (r = 2, 3, 4) and ``mid_shuffle`` (forward,
   and its backward against the plain un-shuffle and ``torch.autograd`` of
   the plain version) must be bit-identical; ``fused_o_branch`` and
   ``fused_modulation`` are also checked on their ``wgmma`` route at B = 2,
   13×21, N = 3, 2C = 128, K = 10 (tiles cut by both edges), at 2C = 64
   (40×70) and with a large positive ``bm`` (a ``relu(bm)`` padding ring
   would show), and on the ``mma`` route at a ragged small shape (2C = 32,
   K = 4), ``head_dot`` and ``fused_tail`` at
   B = 3, 13×21 of 24 columns, C4 = 128 with and without ``pre_bias``,
   ``style_dot_hwbm`` at B = 2, 13×21, M = 264, ``style_blend_dot`` at
   B = 2, 13×21, c2 = 24, M = 264, and ``packed_g123`` at B = 3 on an
   up1-like x [13, 21, 3, 256] and a tail-like packed [8, 12, 3, 512]
   (9.0 and −9.0 planted in its dead row and column). ``fused_tail`` gets
   the raw g4 with its ``pre_bias``, as the ``pallas_tail`` path calls it.
   In bf16 the routed kernels take their fast routes (``head_dot``,
   ``fused_tail``, ``packed_g123``, ``fused_o_branch`` and
   ``fused_modulation``: ``wgmma``; ``style_dot_hwbm`` and
   ``style_blend_dot``: ``tc``), which sum in another order than the plain
   versions (16-deep ``mma`` steps, 64-channel slices outermost), hence the
   same 1e-2 as every bf16 kernel; in fp32 they take the exact CUDA-core
   routes; ``mid_shuffle``, ``output_stage_x8`` and ``output_stage`` take
   ``vec16`` in both types (the output stages also ``v1`` on a ragged case:
   every pixel one element past 16 bytes, a channel slice), and both output
   stages are held bit-identical to their plain versions on every route
   they can take at clamp bounds 0/1 and 0.001/0.999 (``clamp_checks``:
   the bounds rounded to the storage type, 0.999 is 1.0 in bf16). The
   route each took is asserted, and the earlier route of each
   (``head_dot.launch_igemm``, ``fused_tail.launch_igemm``,
   ``packed_chain.launch_igemm``, ``launch_cuda_core``,
   ``launch_blend_cuda_core``, the ``scalar`` shuffle, the ``launch_mma``
   of ``fused_o_branch`` and ``fused_modulation``, the output stages'
   ``v1``) is timed beside it as ``previous_ms``. ``in_stats`` and
   ``fused_in_mod`` take route ``vec16`` at [8,128,128,64] in both types
   (``in_stats`` also on a channel slice of a [8,128,128,256] map), are
   held bit-equal over two calls, launch 1 and 2 device kernels a call (``torch.profiler``) and
   leave the ticket counters at 0 after B = 8 and then B = 3; their ``v1``
   route is ``previous_ms`` and takes a ragged case (C = 24, 13×21, every
   base one element past 16 bytes). Times: ``output_stage_x8``,
   ``output_stage``, ``in_stats``, ``fused_in_mod`` and ``mid_shuffle``
   (kernel, plain, library, previous) are device time, a CUDA graph of
   ≥ 20 launches over ≥ 3 input sets of ≥ 100 MB in all, in turn (so each
   launch finds its inputs out of the 50 MB L2) replayed between two events
   and divided by the launches, median of 5 replays (``graph_ms``), the kernel also
   once a call as ``call_ms``; the other kernels are CUDA-event medians
   of 20 single calls (5 for a call above 20 ms), ``call_ms`` = ``ms``. Beside
   them: the plain version's time, the
   bound (larger of bytes over 3.35 TB/s and operations over the bf16
   tensor-core peak), and one PyTorch call computing the same function
   where there is one.
4. small forwards — reduced DepthNets through the kernels in fp32 against
   the same weights on the CPU (plain versions), ≤ 2e-4 max abs: ×8, ×2,
   ×3, ×4, ×4 with the fused epilogue, ×8 with ``valid_hw`` on a
   zero-padded odd-sized input, and ×8 with ``pallas_obranch``,
   ``fused_modulation``, ``pallas_tail``, the dense tail
   (``packed_tail: false``), and ``preset: plain`` (also ×4 with a depth
   block at nb-1).
5. serving, seven full-width paths through ``FModelDepthCond`` (seeded
   weights, batch 8, bf16), the launch counts set to 0 before each and read
   after it; every output finite, of the right shape, in [0,1]; bf16 vs
   fp32 PSNR ≥ 40 dB on the same weights:
   - ×8 flagship, unbucketed, LQ 128² → SR 1024²: ``packed_g123`` 2
     (bf16: route ``wgmma`` on every ×8 path that runs it; fp32: ``fp32``),
     ``style_blend_dot`` 2 (bf16: route ``tc``; the fp32 request:
     ``cuda_core``), ``head_dot`` 1 (bf16: ``wgmma``; fp32: ``fp32``),
     ``output_stage_x8`` 1 per forward (route ``vec16``, as every output
     stage launch of every path, bf16 and fp32); the fp32 output equals
     that of ``preset: plain`` to ≤ 2e-4, and so does that of each of the next three;
   - the same with ``net_kw: {pallas_obranch: true}`` (hoisted trunk):
     ``fused_o_branch`` 1 (bf16: route ``wgmma``; fp32: ``fp32``),
     ``style_blend_dot`` 0, the tail as above;
   - with ``net_kw: {fused_modulation: true}``: ``fused_modulation`` 1
     (bf16: ``wgmma``; fp32: ``fp32``), ``style_blend_dot`` 0, the tail as
     above;
   - with ``net_kw: {pallas_tail: true}`` (lazy trunk): ``style_blend_dot``
     2 (``tc``), ``packed_g123`` 2, ``fused_tail`` 1 (``wgmma``; fp32:
     ``fp32``), ``head_dot`` 0, ``output_stage_x8`` 0;
   - ``preset: plain``: no kernel launch at all;
   - ×8 flagship with ``eval_bucket_multiple`` unset (bucket 32), LQ
     120×112 → SR 960×896 through the masked forward: ``style_dot_hwbm`` 2
     (bf16: route ``tc``; fp32: ``cuda_core``), ``output_stage`` 1, none of
     the packed kernels; the fp32 output equals the fp32 unbucketed output of
     the same request to ≤ 1e-4;
   - ×4 flagship with ``net_kw: {fused_epilogue: true, in_stats:
     kernel}``, LQ 128²
     → SR 512²: ``fused_in_mod`` 26, ``in_stats`` 26 (both route ``vec16``
     in both types), ``style_blend_dot`` 2 (``tc``), ``output_stage_x8`` 1;
     the fp32 output equals that of the chained
     epilogue (``fused_epilogue: false``) to ≤ 2e-4.

6. train — (a) the flagship training step (``models/recipes.py``: the ×8
   YAML's ``train:`` block, L1 + dynamic SmoothL1 × 10, cosine restarts,
   β2 0.99), bf16, batch 8 of seeded uint8 LQ 128² / GT 1024² on the card,
   four steps with the launch counts set to 0 before and read after:
   ``packed_g123`` 2, ``style_blend_dot`` 2, ``head_dot`` 1,
   ``output_stage_x8`` 1 a step (routes ``wgmma``, ``tc``, ``wgmma``,
   ``vec16``), every loss finite and step 4's below step 1's; ms a step
   (steps 2–4, host clock, synchronised) and the peak device memory. The
   same four steps from the same weights in fp32 and in bf16 with
   ``preset: plain``: step 1's loss and gradients (norm-relative over all)
   no farther from the fp32 step's than 2× plain PyTorch bf16's are.
   (b) One fp32 step, batch 2, full width, of the default configuration
   against ``preset: plain`` on the same weights and batch, each clause
   held to what four one-ulp nudges of the plain path (LQ up and down,
   every weight up or down at random, twice) move (the clamp at 0, the
   ReLUs move the small SEAN gradients by percents; ``parity_readings``;
   the steps take cuDNN's deterministic algorithms, so a reading is the
   same from run to run): logs ≤ 1e-5
   relative; each tensor's norm-relative difference ≤ 4× the largest
   change the nudges make in it + 2e-4; all gradients as one vector ≤ the
   larger of 2e-4 and 4× the nudges' change of it; the conv biases before
   an InstanceNorm (zero true gradient) ≤ the larger of 1e-7 and 4× what
   the plain path and its nudges hold, of the largest gradient; the
   updated parameters' difference over their move ≤ 4× the largest
   nudge's. (c) Each of the nine kernels with a
   gradient, bf16 and fp32, at the full-width shapes: every input's
   gradient through the wrapper (kernel forward, ``*_vjp`` backward)
   against autograd of the plain version, max |Δ| / max |ref| ≤ 1e-4 in
   fp32 and 2⁻⁴ in bf16 (``fused_o_branch`` and ``fused_modulation``
   follow the JAX twin's roundings); ``in_stats`` and ``fused_in_mod``
   must raise ``NotImplementedError`` under autograd.
7. entry points — ``python -m endosr_torch.train`` and ``.test`` through
   their ``main``, as a user runs them. A synthetic Kvasir-style tree under
   ``build/entry/`` (written with ``cv2``; 16 train pairs of smooth
   random GT 1024² and LR 128², the MATLAB bicubic of GT, 2 test pairs
   of GT 960×896 / LR 120×112 so that bucketing pads, ``<stem>_disp.npy``
   depth), and YAMLs derived from the repo's ×8 training YAML and test
   YAML with only the data roots, ``path.root``, ``data_num``, ``niter``,
   ``val_freq``, ``save_checkpoint_freq`` and ``print_freq`` changed
   (each logged as a ``reduced`` line): batch 8, GT 1024², 4 loader
   workers, ``cache_data``, ``u8_pipeline``, flips and rotations, fp32.
   Training: 4 steps, 2 an epoch, saved at 2 and 4, validated at 4; each
   ``optimize_parameters`` and ``test`` call runs with the counts set to 0
   just before and read just after: a step launches ``packed_g123`` 2
   (route ``fp32``), ``style_blend_dot`` 2 (``cuda_core``), ``head_dot`` 1
   (``fp32``), ``output_stage_x8`` 1 (``vec16``), a validation image
   ``style_dot_hwbm`` 2 (``cuda_core``) and ``output_stage`` 1
   (``vec16``); losses finite; checkpoints, validation PNGs and log lines
   written. A copy of the run without its step-4 files resumes with
   ``resume_state: auto``: the state it loads equals step 2's bit for bit
   (Adam, weights, K-vector, update count); it reruns epoch 0 from its
   first batch as steps 3–4, as the JAX ``train.py`` does, and its losses
   are within 1e-4 relative of a replay of that rule through the model
   API (``resume_training`` of ``2.state``, then epoch 0's two batches;
   cuDNN's backward is not bit-stable). Evaluation: ``latest_G.pth`` with
   its output conv scaled and shifted (``eval_G.pth``) so that the fp32
   output of the test images has its median at 0.5 and its 1st–99th
   percentiles within [0.1, 0.9] (four steps from random weights leave it
   clamped at 0 almost everywhere); precision auto-selected bf16, an image
   launches ``style_dot_hwbm`` 2 (``tc``) and ``output_stage`` 1
   (``vec16``), the TSV's header, rows and ``Average``, 2 PNGs of 960×896,
   and over the pixels that neither run clamps (at least 90 % of them)
   each SR ≥ 40 dB against an fp32 serve of the same weights. Logged: ms
   a training step (steps 2–4),
   peak device memory, the loader's images/s (its first epoch fills the
   cache), validation and eval ms an image.

8. ×2 / ×3 serving — (a) every kernel call of the ×2 and ×3 paths at its
   path's shape and type (``X23_CALLS``: ``style_dot_hwbm`` bf16 ``tc``
   at [8,512,512,90]×[8,90,1792 / 1536] and [1,191,166,90]×[1,90,1792 /
   1536], ``style_blend_dot`` fp32 ``cuda_core`` and bf16 ``tc`` at the ×2
   groups, ``output_stage`` r = 2 at [8,512,512,12] fp32 and bf16
   ``vec16``, r = 3 at [1,191,166,27] fp32 ``v1``), its route asserted,
   against its plain version on the same inputs (the dots image by image,
   fp32 against float64 ≤ 1e-5, bf16 ≤ 1e-2 of max |ref|; the output
   stages bit for bit); the errors join the JSON rows' ``max_abs_err``.
   (b) ``centered_conv`` on one trunk conv
   ([8,512,512,64]×[3,3,64,64], an offset-carrying stream): the same bits
   with the process's TF32 flag on and off (its exact-product passes allow
   TF32 locally), 1 / 2 / 3 passes against the float64 conv (3 passes
   ≤ 2e-5, 1 pass ≤ 2e-2 of max |ref|), and the ms of 1, 2 and 3 passes,
   of the bf16 conv and of the fp32 conv (TF32 off). (c) The ×2 YAML's
   network (nb 16, every block a depth block, latent 32; its training
   field ``remat_blocks`` dropped, logged as ``reduced``), batch 8, LQ 512²
   → SR 1024², ``eval_bucket_multiple: 0``, seeded weights; the reference
   is fp32 ``preset: plain`` on the same weights and requests (no kernel
   launched, asserted; TF32 off; run 2 images at a time), then fp32,
   bf16c3, bf16c, mixed and bf16: each precision a warm-up request, then 2
   with the counts set to 0 just before and read just after: fp32
   ``style_blend_dot`` 2 (``cuda_core``) and ``output_stage`` 1
   (``vec16``) a request; bf16 the same on ``tc``; mixed, bf16c and bf16c3
   ``style_dot_hwbm`` 2 (``tc``; JAX's blend kernel does not fit LQ 512²
   at batch 8, so the style groups go where the JAX module sends them) and
   ``output_stage`` 1 (``vec16``); host ms, device busy ms
   (``torch.profiler``, one request), peak memory; SR finite, fp32, in
   [0, 1]; fp32 within 2e-4 of the plain reference, the others'
   mismatch-PSNR against it over all values ≥ the JAX package's floors
   (bf16c3 50 dB, mixed 45, bf16c 40, bf16 25;
   ``tests/test_bf16_quality.py``), also logged over the unclamped values.
   (d) ``python -m endosr_torch.test`` through ``main`` at ×3: the test
   YAML with the ×3 YAML's network and EndoScene dataset block on a
   synthetic CVC-EndoSceneStill split under ``build/endoscene/`` (4 frames
   of GT 574×500, LR 191×166 under ``x3/``, a split file), ``precision``
   unset: ``bf16c3`` auto-selected, unbucketed; each image's ``test`` with
   the counts set to 0 just before and read just after:
   ``style_dot_hwbm`` 2 (``tc``), ``output_stage`` 1 (route ``v1``: a
   row of 166·27 values is no multiple of 16 bytes); the TSV, 4 PNGs of
   573×498, each SR ≥ 40 dB against an fp32 ``preset: plain`` serve (no
   kernel launched, asserted) over the values neither run clamps; ms an
   image. The phase's seconds are logged.

9. ×2 / ×3 / ×4 training, ``remat_blocks``, the ablations, TF32 — (a)
   ``python -m endosr_torch.train`` through ``main`` on each shipped
   training YAML but ×8 (phase 7's), fp32 as they leave it, at their own
   batch, sizes and ``remat_blocks``: ×2 Kvasir (batch 2, LQ 512² → GT
   1024², ``remat_blocks``: ``output_stage`` 1 a step, ``vec16``), ×4
   Kvasir (batch 8, LQ 256², ``remat_blocks``: ``output_stage_x8`` 1,
   ``vec16``), EndoScene ×2 / ×3 / ×4 (batch 8 / 4 / 8, whole 574×500
   frames cut to the scale: ``style_blend_dot`` 2, ``cuda_core``, and
   ``output_stage`` 1 (×3: ``v1``) or ``output_stage_x8`` 1), 3 steps on
   synthetic trees under ``build/train9/`` (16 pairs or frames), with the
   data roots, ``path.root``, ``data_num``, ``niter``, ``val_freq``,
   ``save_checkpoint_freq``, ``print_freq`` and, for EndoScene, a
   ``manual_seed`` at which no batch mixes upright and transposed frames
   (JAX's loader raises there too, C7) changed, each logged as
   ``reduced``; each step with the counts set to 0 just before and read
   just after (counts and routes asserted), losses finite; ms a step,
   peak memory, the loader's images/s over the run's batches. (b) The ×2
   Kvasir YAML's step (batch 2, LQ 512², fp32) with and without
   ``remat_blocks`` from the same weights and batch: the peak with it
   below the peak without it, and the two held to each other by phase
   6b's rule. (c) Each of the ×2 (``remat_blocks``), ×3 EndoScene (LQ
   191×166) and ×4 (``remat_blocks``, LQ 256²) nets' fp32 step, batch 2,
   against ``preset: plain`` of the same net by phase 6b's rule; at ×3
   also the ×3 step again with each of two wrong ``style_blend_dot``
   backwards in its place (``vjp_controls``), held to plain by the same
   rule: the one without its bias term must be rejected, the bf16 one is
   read (``step_controls``); and the plain step again, its gradients
   equal to the first run's (cuDNN's deterministic algorithms; with its
   default ones, two runs' differing tensors are counted:
   ``rerun_check``). (d)
   ``ablate_depth_matrix``, ``ablate_depth_block`` and the baseline on
   the ×4 YAML's net: an fp32 request (batch 8, LQ 127²) within 2e-4 of
   its ``preset: plain`` twin, a bf16 request ≥ 40 dB against it, an fp32
   training step (batch 2, LQ 63²) against ``preset: plain`` by phase
   6b's rule; ``output_stage_x8`` 1 a request or step. (e) TF32 (C6): one
   ×8 fp32 request (phase 5's net) and one ×2 ``bf16c3`` request (phase
   8's) with PyTorch's default TF32 and with it off: ms, max |Δ| and PSNR
   against fp32 ``preset: plain``. (f) Every kernel call that 9a–9d
   made, recorded by ``KernelTap`` (kernel, type, route, shape, clamp,
   whether an input required a gradient), again on the card at that
   shape against its plain version (``kernel_call_check``, as 8a: the
   blends image by image, fp32 against float64 ≤ 1e-5 of max |ref|, the
   output stages bit for bit), and so is its gradient where the path took
   one (the blend's per input ≤ 1e-5 of max |ref| against float64, the
   output stages' bit for bit); the errors join the JSON rows'
   ``max_abs_err``. Then the gradient check of the smallest fp32 blend
   call with each wrong backward in place must fail. The phase's seconds
   are logged.

10. frames → depth maps → SR, and the depth and VGG losses — seeded
   weight files under ``build/depth10/`` (a ResNet-18 ``encoder.pth`` at
   feed 256×320, ``depth.pth``, a VGG19 ``vgg19.pth``) and a synthetic
   Kvasir tree there (16 pairs, LR 128², GT 1024²). (a) The producer,
   ``depth/infer.py::run_folder``, on the 16 LR frames on the card
   (twice): ``f00_disp.npy``… of [1, 1, 256, 320] float32 and the
   previews; the disparities within 1e-4 of max |ref| of the port's CPU
   fp32 run; ms a frame. (b) ``python -m endosr_torch.tools.sr_pipeline``
   through ``main`` with ``--depth_weights``, the ×8 flagship at its
   defaults, ``--bucket 0``, batch 8, a seeded ``G.pth`` (its output conv
   centred as phase 7's), ``--precision bf16`` and then fp32: each
   ``test`` with the counts set to 0 just before and read just after,
   ``packed_g123`` 2, ``style_blend_dot`` 2, ``head_dot`` 1,
   ``output_stage_x8`` 1 a batch (bf16: ``wgmma``, ``tc``, ``wgmma``,
   ``vec16``; fp32: ``fp32``, ``cuda_core``, ``fp32``, ``vec16``); 16
   PNGs of 1024²; against fp32 ``preset: plain`` (no kernel) on the same
   inputs, bf16 ≥ 40 dB and fp32 ≤ 2e-4; ms a frame by stage (depth
   maps, model, serving, reading/masks/PNGs) and end to end. (c) ``python
   -m endosr_torch.train`` through ``main`` on the ×8 YAML with phase 7's
   key changes and ``use_depth_criterion``, ``pretrained_model_path``,
   ``use_vgg_criterion`` and ``vgg_weights_path`` set (each logged as
   ``reduced``), fp32 (TF32 off), batch 8, GT 1024², 3 steps: the four
   kernels a step as (b)'s fp32, ``l_depth``/``l_vgg`` and their scales
   finite; then the model's step 0 with the cwd under ``build/depth10/
   dump``: ``_dump_disparities`` writes its 8 arrays ([8, 256/2^i,
   320/2^i, 1]); the frozen networks equal their files, take no gradient,
   stay in ``eval()`` and are in no optimizer group; ms a step, peak
   memory. (d) One fp32 batch-2 step of that recipe against ``preset:
   plain`` by phase 6b's rule. (e) Every kernel call of (b)–(d), recorded
   by ``KernelTap``, again at its shape against its plain version,
   forward and gradient, as 9f (``packed_g123`` and ``head_dot`` held
   whole: fp32 against float64 ≤ 1e-5, bf16 ≤ 1e-2 of max |ref|, their
   gradients against autograd of the plain version at their type ≤ 1e-4
   fp32, 2⁻⁴ bf16); the errors join the JSON rows' ``max_abs_err``.

11. the self-supervised depth trainer — a synthetic sequence under
   ``build/depth11/`` (62 frames 320×400 of a shaded, textured image
   panned and zoomed a little a frame; a stereo ``image01`` /
   ``image02`` layout of 14 frames with GT depth PNGs). (a) ``python -m
   endosr_torch.depth.train`` through ``main`` at the endovis defaults
   (feed 256×320, batch 12, ResNet-18, ``separate_resnet``, frames [0,
   -1, 1], scales 0–3, Adam 1e-4, 4 spawned loader workers) with
   ``num_epochs`` 1 and ``log_frequency`` 1 (logged as ``reduced``): 5
   steps, ms a step (host clock, synchronised), every loss finite, peak
   memory, the loader alone over 3 more epochs against the steps' rate.
   (b) One full-width step (after a warm-up step) of each of ``posecnn``,
   stereo (``EndovisDataset`` with ``l`` / ``r`` sides and ``'s'``),
   stereo alone ([0, 's'], no pose network), ``v1_multiscale``,
   ``avg_reprojection``, ``disable_automasking``, ``no_ssim`` and
   ``--num_layers 50``: finite losses, ms. (c) One fp32 step (loss and
   gradients) at batch 2 on the card against the port on the CPU: the
   same weights, batch and noise; losses ≤ 1e-5 relative, gradients by
   phase 6b's rule (the one-ulp nudges of both sides); the card's step
   twice, both readings passing. (d) ``save_model`` → a fresh trainer's
   ``load_model`` bit-equal (networks, Adam, step); ``run_folder`` on the
   card reads the trained folder; ``evaluate_depth`` over the stereo
   layout's frames gives 7 finite metrics. (e) No SR kernel launches in
   the phase: every count 0, as ``launches_by_path["depth train"]``.

12. the other models — fp32 (TF32 off), seeded weights, synthetic data
   written with ``cv2`` under ``build/models12/`` (deleted after). (a)
   ``sr`` MSRResNet ×4 (nf 64, nb 16) in BasicSR's recipe
   (``models/recipes.py::msrresnet_x4_yaml``: batch 16, GT 128², L1,
   Adam 2e-4, β2 0.99) through ``python -m endosr_torch.train``
   (``main``), 3 steps (each key changed logged as ``reduced``); ``python
   -m endosr_torch.test`` on 2 images of GT 512²; ``SRModel.test_x8`` on
   a batch of 8, LQ 128². (b) RRDBNet (nf 64, nb 23, gc 32): a batch-8
   request at LQ 128² (its TFLOP from the shapes) and 3 steps at batch
   16, LQ 32². (c) IKC: ``predictor`` (``LQker`` data), ``sftmd`` with
   ``SFTMD_kernel`` (nf 64, nb 16, code 10; the batch's ``ker_map``) and
   ``corrector`` (``SRker`` data), 3 steps each at batch 16, LQ 64², from
   seeded codes; one chained request Predictor → SFTMD → Corrector at
   batch 8, LQ 128². (d) ``sftmd`` (the kernel-free SFTMD, ×4) and
   ``sftmd_depth`` (``SFTMD_upsacle_after_ResBlk_depth``, learned depth
   maps, 3 SPADE blocks, ×8), 3 steps each at batch 8, LQ 64²; batch-8
   forwards of ``SFTMD_upsacle_after_ResBlk`` and its ``_depth_condition``
   variant at LQ 128² → 1024². Each step and request with the counts set
   to 0 just before and read just after: no kernel launch (these networks
   have none, in JAX as here), losses finite, outputs finite and of their
   shape; ms a step (median of steps 2–3) and a request, peak memory.
   (e) ``sftmd_depthSegNet`` (``models/recipes.py::depthseg_yaml``: the
   EndoScene ×2 YAML's DepthNet + FCN8s) through ``main`` on 16 frames of
   384×288 (CVC-ClinicDB's size: whole 574×500 frames fail in the FCN,
   C11), batch 8, 3 steps, at the first seed whose batches stack under
   the rotations (C7): ``style_blend_dot`` 2 (``cuda_core``) and
   ``output_stage`` 1 (``vec16``) a step, the FCN's BatchNorm statistics
   finite, ``{iter}_segNet.pth`` written; one fp32 batch-2 step against
   ``preset: plain`` by phase 6b's rule; every kernel call of the phase
   again alone against its plain version, forward and gradient, as 9f.
   (f) For each model of (a)–(d) at batch 2, step 1 on the card and on
   the CPU from the same seeded weights and batch: losses ≤ 1e-5
   relative, ``test``'s outputs ≤ 2e-4 of max |ref|, the updated
   parameters apart by no more than 4× the largest change either side's
   step makes under phase 6b's four one-ulp nudges.

13. the GAN models, their data and the degradation toolkit — fp32 (TF32
   off), seeded weights and a seeded VGG19 file (``write_seeded_vgg``: the
   repo holds no VGG weights), synthetic data under ``build/gan13/``
   (deleted after). (a) ESRGAN at its published recipe: ``srgan`` with
   RRDBNet (nf 64, nb 23, gc 32) and ``discriminator_vgg_128`` (nf 64),
   batch 16, LR 32² → GT 128², ``ragan``, L1 pixel 1e-2, L1 VGG feature
   1, GAN 5e-3, D every step: 3 steps, ms a step (median of steps 2–3),
   the first, peak memory. (b) MSRResNet (nf 64, nb 16) SRGAN at the same
   sizes with ``D_update_ratio`` 2 for ``gan``, ``lsgan`` and
   ``wgan-gp``: a D-only and a G + D step (twice), each gate's log keys.
   (c) ``sftgan`` (SFTNet, ACD_VGG_BN_96), batch 16, LR 24² → HR 96²,
   pixel 1, feature 1, GAN 5e-3, categories drawn over 0–7: steps 1, 2
   (the non-SFT parameters unchanged) and 20001 (they move). (d) SFTNet
   (``SFTGANACDModel.test``) and SFTNetTorch serve a batch-8 request at
   LR 128² (segmentation 512²). (e) An ``LRHR_seg_bg`` loader (4 workers,
   batch 16) over 16 PNGs of 480² with segmentation ``.npy`` and 4
   background images: items/s, an SFT-GAN step on its first batch;
   ``SRMDPreprocessing`` at batch 16, HR 256², ×4, l 21, anisotropic,
   with noise: ms a call. Each step and request with the counts set to 0
   just before and read just after: no kernel launch (these networks have
   none, in JAX as here), losses finite. (f) ESRGAN, the MSRResNet SRGAN
   with each loss and SFT-GAN at step 20001, batch 2, LR 32² (SFT 24²),
   one step on the card and on the CPU from the same seeded weights and
   batch: losses ≤ 1e-6 relative, ``test``'s outputs ≤ 1e-5 of max |ref|,
   the updated G and D weights and D's running statistics each within 4×
   the largest change either side's step makes under phase 6b's four
   one-ulp nudges; ``SRMDPreprocessing`` and ``IsoGaussian`` on the same
   draws ≤ 1e-5 of max |ref|.

14. data-parallel training and H-sharded serving — (a) the flagship
   ×8 YAML's step (bf16, batch 8 of seeded uint8 LQ 128² / GT 1024², 14
   depth blocks, K 10, latent 256, ``dynamic_loss`` on; cuDNN's
   deterministic algorithms) on the single-device model, then through a
   1-rank NCCL process group (``parallel/mesh.py``: the model built over
   the mesh, its losses' global sums, the gradient all-reduce, the logs'
   mean): logs, step 1's gradients and the parameters after 1 and 4
   steps bit-equal; ms a step of both (steps 2–4); ``packed_g123`` 2,
   ``style_blend_dot`` 2, ``head_dot`` 1, ``output_stage_x8`` 1 a step.
   (b) Two ranks spawned on this card over gloo (NCCL refuses two ranks on
   one GPU; ``python3 chip_smoke.py --p14-rank dp <dir>`` with torchrun's
   environment), 4 images each, from the same weights: each rank's
   launches as (a)'s; both ranks' parameters bit-equal; against the
   1-rank step on the 8 images, the loss, each gradient (norm-relative),
   all gradients as one vector and the first update, each within
   ``P14_ORDER`` (4) × the largest change the 1-rank step itself makes
   with its batch's halves swapped (every sum over the batch in another
   order) or its weights nudged one ulp (phase 6b's nudges): the loss +
   1e-6 relative, all gradients and the update at least 2e-4; each
   gradient tensor within 4× the largest of those and of the 1-rank step
   with the network run on each rank's 4 images in turn (a rank's shapes:
   cuDNN and the kernels' backward sum in other orders at 4 images than
   at 8) + 2e-4, and within 4× the swap / nudges + 2e-4 of that in-shares
   step. A rank that exits with another code than 0 fails the phase.
   (``python3 chip_smoke.py --gloo-probe``, outside this run, reads which
   collectives gloo carries for CUDA tensors.) (c) ×2 fp32 serving at
   full width (the
   test YAML's ``network_G``: nb 16, latent 256, K 10, blocks 0–13;
   seeded weights), ``spatial_shard: 4`` through ``FModelDepthCond.test``
   on 4 ranks on this card over gloo: an LR 250×186 frame (H and W
   misaligned; bucket 32 → 256×192) within 1e-4 of the unsharded masked
   forward, ``style_dot_hwbm`` 2 and ``output_stage`` 1 a rank a request;
   an LR 512² frame: peak memory and ms a rank against the unsharded
   request's. (d) Every kernel call of (a)–(c), recorded by ``KernelTap``
   (the ranks' too), again at its shape against its plain version,
   forward and gradient, as 9f. ``python3 chip_smoke.py --p14-nccl N``
   (a call on N cards, not run without arguments) checks (b) and (c) with
   one rank a card over NCCL instead.
15. JAX's checkpoint files (``utils/checkpoint.py``; ≤ 60 s). (a)
   ``python -m endosr_torch.train`` through ``main`` on the ×8 YAML at full
   width (phase 7's changes, the loader in order, without flips and in
   this process, so that every epoch is the same two batches,
   ``checkpoint_backend: msgpack``, 4 steps, saving at 2): JAX's ``{iter}_G.ckpt`` and ``{iter}.state``. (b)
   A run resumed from its ``2.state`` (``resume_state: auto``): steps 3–4
   logs, ``4_G.ckpt`` and ``4.state``'s iteration, optimizer state and
   weights bit-equal to (a)'s (cuDNN's deterministic algorithms; its epoch
   is 0, as the resumed run reruns epoch 0, C3). (c) ``test.main`` with ``pretrain_model_G:
   4_G.ckpt``, unbucketed (LR 128², bf16): ``packed_g123`` 2,
   ``style_blend_dot`` 2, ``head_dot`` 1 and ``output_stage_x8`` 1 an
   image, the SR bit-equal to the same model served with (a)'s in-memory
   weights. (d) The JAX-written fixture ``tests/data/jax_ckpt/`` (a ×8
   DepthNet that the JAX package trained two steps and saved,
   ``tests/make_jax_ckpt_fixture.py``): its ``2_G.ckpt``'s fp32 forward
   within 2e-4 of max |ref| of JAX's stored output; its ``2.state``
   resumes (weights equal to the ``.ckpt``'s, Adam counts 2) and steps.

Phase 3 also holds the two kernel options no path passes against their
plain versions, at the flagship's shapes: ``packed_g123[k4]`` (the up1
chain with the absorbed stage 4, k4 [2,2,128,512]; stage 4 on the shared
implicit GEMM, route ``k4_mma`` / ``k4_fp32``) and
``style_blend_dot[hwbc]`` (the M = 1792 group, ``shifted`` given as
[H,W,B,J]; routes ``tc_hwbc`` / ``cuda_core_hwbc``); each is a row of the
kernels line, with 0 launches.

Prints the kernels JSON line (``launches`` summed over the paths and the
training steps, ``launches_by_path`` with phase 7's ``train entry``,
``val entry`` and ``eval entry``, phase 8's ``x2 <precision>`` and
``x3 eval``, and phase 9's ``x2 train``, ``x4 train``, ``x2 endoscene
train``, ``x3 endoscene train``, ``x4 endoscene train``, ``x2 remat``,
``x2 hoisted``, ``x3 endoscene grads``, ``x4 remat grads``,
``ablate_depth_matrix``, ``ablate_depth_block`` and ``baseline``,
phase 10's ``x8 pipeline bf16``, ``x8 pipeline fp32``, ``x8 train
losses``, ``x8 train losses step 0`` and ``x8 losses grads``, and phase
11's ``depth train`` (0 for every kernel), and phase 12's ``12e
depthseg train`` and one label for each run of 12a–12d (0 for every kernel),
phase 13's one label for each run of 13a–13e (0 for every kernel),
phase 14's ``14a dp world 1``, ``14b dp world 2`` and ``14c spatial x2``
(the ranks' launches summed), phase 15's ``15a train``, ``15b resumed``,
``15c eval`` and ``15d fixture``,
``grad_checked`` / ``grad`` / ``grad_max_rel_err`` from
phase 6c (``mid_shuffle``: its backward in phase 3),
``timing`` "graph" or "call";
``mid_shuffle`` is a kernel no forward calls, in the JAX package as here, so
its count is 0 and it is held to its plain version in phase 3 only), then the ``nvidia-smi`` name/power line, then ``{"ok": true, "device":
{...}}`` as the last line. Exits non-zero without a result when no CUDA
device is present or when run outside the repository.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BPS = 3.35e12       # H100 SXM device memory rate
BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
N_TIMED = 20


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, n=N_TIMED):
    """Median CUDA-event time of ``fn()`` over ``n`` runs, after warm-up."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if time.perf_counter() - t0 > 0.02:
        n = min(n, 5)
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


N_GRAPH = 20           # launches a timing graph holds at least
ROTATE_BYTES = 100e6   # input sets a timing graph rotates over hold this


def graph_ms(fn, sets, k_min=N_GRAPH):
    """Device ms of one call of ``fn``: a CUDA graph of K ≥ ``k_min`` calls
    ``fn(*inputs)`` with ``inputs`` running over ``sets`` in turn (so a call
    finds its inputs out of the L2 cache), replayed between two events and
    divided by K; the median of 5 replays after one warm-up replay. A
    capture that fails raises."""
    import torch

    k = -(-k_min // len(sets)) * len(sets)
    for inputs in sets:                 # warm-up, outside the capture
        fn(*inputs)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(k):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / k)
    del graph
    times.sort()
    return times[len(times) // 2]


def rotation(first, more):
    """Input sets for :func:`graph_ms`: ``first`` and calls of ``more()``
    until their tensors' elements (:func:`nbytes`: a channel slice counts
    its own elements, not the bytes of the map it spans) hold
    ``ROTATE_BYTES``, at least three sets, so no set is still in the L2
    when its turn comes again."""
    sets = [first]
    while len(sets) < 3 or sum(nbytes(*s) for s in sets) < ROTATE_BYTES:
        sets.append(more())
    return sets


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(bytes_, flops):
    tb, tf = bytes_ / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def rel_err(got, ref):
    """(max |Δ|, max |Δ| / max |ref|) of a tensor or a tuple of tensors
    (the worst of its members)."""
    if isinstance(got, tuple):
        errs = [rel_err(g, r) for g, r in zip(got, ref)]
        return max(e[0] for e in errs), max(e[1] for e in errs)
    got, ref = got.double(), ref.double()
    return (float((got - ref).abs().max()),
            float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)))


class KernelCase:
    """One kernel at one shape: its call, plain call, library call and the
    bytes/operations of the work. ``main``: its times enter the JSON row
    (the shapes of the first full-width path that runs the kernel); other
    shapes are checked and logged only. ``exact``: must equal the plain
    version bit for bit. ``ref64``: the float64 reference where the plain
    version cannot be fed float64. ``tol``: overrides the per-dtype
    tolerance. ``extra``: a further check of the case, run once per type.
    ``previous``: the kernel's earlier route on the same inputs, timed in
    bf16. ``route``: (wrapper, {dtype: route name}), the route the call must
    take. ``timed=False``: checked only. ``rotate``: (the case's own input
    set, a function making one more), where the call, plain, library and
    previous functions take an input set as positional arguments in place
    of their defaults; such a case is timed by :func:`graph_ms` over a
    :func:`rotation` of input sets (and once a call, as ``call_ms``)."""

    def __init__(self, name, kernel, plain, library, bytes_, flops, main=True,
                 exact=False, ref64=None, tol=None, extra=None, previous=None,
                 route=None, timed=True, rotate=None):
        self.name, self.kernel, self.plain = name, kernel, plain
        self.library, self.bytes, self.flops = library, bytes_, flops
        self.main, self.exact, self.ref64, self.tol = main, exact, ref64, tol
        self.extra, self.previous, self.route = extra, previous, route
        self.timed, self.rotate = timed, rotate


def make_cases(torch, dt, gen):
    """The twelve kernels at the shapes the full-width forwards give them
    (B=8, LR 128; packed_g123, style_blend_dot and style_dot_hwbm twice)."""
    import torch.nn.functional as F

    from endosr_torch.kernels.fused_in_mod import (fused_in_mod,
                                                   fused_in_mod_plain)
    from endosr_torch.kernels.fused_in_mod import launch as in_mod_launch
    from endosr_torch.kernels.fused_mod import (fused_modulation,
                                                fused_modulation_plain)
    from endosr_torch.kernels.fused_mod import launch_mma as mod_mma
    from endosr_torch.kernels.fused_obranch import (fused_o_branch,
                                                    fused_o_branch_plain,
                                                    grouped_w2)
    from endosr_torch.kernels.fused_obranch import launch_mma as obranch_mma
    from endosr_torch.kernels.fused_tail import fused_tail, fused_tail_plain
    from endosr_torch.kernels.fused_tail import launch_igemm as tail_igemm
    from endosr_torch.kernels.head_dot import (head_dot, head_dot_plain,
                                               launch_igemm)
    from endosr_torch.kernels.in_stats import in_stats, in_stats_plain
    from endosr_torch.kernels.in_stats import launch as stats_launch
    from endosr_torch.kernels.output_stage import launch as os_launch
    from endosr_torch.kernels.output_stage import (launch_x8, output_stage,
                                                   output_stage_plain,
                                                   output_stage_x8,
                                                   output_stage_x8_plain)
    from endosr_torch.kernels.packed_chain import launch_igemm as packed_igemm
    from endosr_torch.kernels.packed_chain import packed_g123, packed_g123_plain
    from endosr_torch.kernels.shuffle_mid import launch as shuffle_launch
    from endosr_torch.kernels.shuffle_mid import (mid_shuffle,
                                                  mid_shuffle_plain,
                                                  mid_unshuffle_plain)
    from endosr_torch.kernels.style_dot import (launch_blend_cuda_core,
                                                launch_cuda_core,
                                                style_blend_dot,
                                                style_blend_plain,
                                                style_dot_hwbm, style_dot_plain)

    dev = "cuda"

    def rn(*shape, s=1.0, mean=0.0, dtype=dt):
        return (torch.randn(shape, generator=gen, device=dev) * s
                + mean).to(dtype)

    B = 8
    cases = {}

    # output_stage_x8: the ×8 forward's pre64 [256, 8, 256, 64] HBWC (the
    # JSON row) and the ×4 unmasked forward's [8, 128, 128, 64] BHWC, route
    # vec16 in both types, v1 timed as previous; a ragged case (every pixel
    # one element past 16 bytes) on v1; each at clamp bounds 0/1 and
    # 0.001/0.999 on every route it can take (clamp_checks)
    vec16 = {torch.bfloat16: "vec16", torch.float32: "vec16"}
    v1 = {torch.bfloat16: "v1", torch.float32: "v1"}
    xcs = []
    for label, shape, order, main in (("x8 hbwc", (256, B, 256, 64), "hbwc", True),
                                      ("x4 bhwc", (B, 128, 128, 64), "bhwc", False)):
        pre64 = rn(*shape, s=0.6, mean=0.5)
        xcs.append(KernelCase(
            f"output_stage_x8[{label}]",
            lambda p=pre64, o=order: output_stage_x8(p, 0.0, 1.0, o),
            lambda p=pre64, o=order: output_stage_x8_plain(p, 0.0, 1.0, o),
            None, nbytes(pre64) + pre64.numel() // 64 * 48 * 4, 0, main=main,
            exact=True, route=(output_stage_x8, vec16),
            previous=lambda p=pre64, o=order: launch_x8(p, 0.0, 1.0, o, "v1")[0],
            extra=lambda p=pre64, o=order, n=label: clamp_checks(
                torch, dt, f"output_stage_x8[{n}]",
                lambda lo, hi, route: launch_x8(p, lo, hi, o, route),
                lambda lo, hi: output_stage_x8_plain(p, lo, hi, o)),
            rotate=((pre64,), lambda s=shape: (rn(*s, s=0.6, mean=0.5),))))
    xr = rn(3, 13, 21, 65, s=0.6, mean=0.5)[..., 1:]
    xcs.append(KernelCase(
        "output_stage_x8[ragged 13×21, unaligned]",
        lambda p=xr: output_stage_x8(p, 0.001, 0.999),
        lambda p=xr: output_stage_x8_plain(p, 0.001, 0.999), None, 0, 0,
        main=False, exact=True, timed=False, route=(output_stage_x8, v1),
        extra=lambda p=xr: clamp_checks(
            torch, dt, "output_stage_x8[ragged]",
            lambda lo, hi, route: launch_x8(p, lo, hi, "bhwc", route),
            lambda lo, hi: output_stage_x8_plain(p, lo, hi), ("v1",))))
    cases["output_stage_x8"] = xcs

    # output_stage: the bucketed ×8 forward's [8,256,256,48] r=4 (main path),
    # and the ×4 / ×2 / ×3 tails' shapes, route vec16, v1 as previous; a
    # ragged case (a channel slice, pixel stride 64) on v1
    ocs = []
    for label, hw, r, main in (("x8 r=4", 256, 4, True), ("x4 r=4", 128, 4, False),
                               ("x2 r=2", 128, 2, False), ("x3 r=3", 128, 3, False)):
        pre = rn(B, hw, hw, 3 * r * r, s=0.6, mean=0.5)
        ocs.append(KernelCase(
            f"output_stage[{label}]",
            lambda p=pre, r=r: output_stage(p, r, 0.0, 1.0),
            lambda p=pre, r=r: output_stage_plain(p, r, 0.0, 1.0),
            None, nbytes(pre) + B * hw * hw * 3 * r * r * 4, 0, main=main,
            exact=True, route=(output_stage, vec16),
            previous=lambda p=pre, r=r: os_launch(p, r, 0.0, 1.0, "v1")[0],
            extra=lambda p=pre, r=r, n=label: clamp_checks(
                torch, dt, f"output_stage[{n}]",
                lambda lo, hi, route: os_launch(p, r, lo, hi, route),
                lambda lo, hi: output_stage_plain(p, r, lo, hi)),
            rotate=((pre,), lambda s=pre.shape: (rn(*s, s=0.6, mean=0.5),))))
    orr = rn(3, 13, 21, 64, s=0.6, mean=0.5)[..., :48]
    ocs.append(KernelCase(
        "output_stage[ragged 13×21, channel slice, r=4]",
        lambda p=orr: output_stage(p, 4, 0.001, 0.999),
        lambda p=orr: output_stage_plain(p, 4, 0.001, 0.999), None, 0, 0,
        main=False, exact=True, timed=False, route=(output_stage, v1),
        extra=lambda p=orr: clamp_checks(
            torch, dt, "output_stage[ragged]",
            lambda lo, hi, route: os_launch(p, 4, lo, hi, route),
            lambda lo, hi: output_stage_plain(p, 4, lo, hi), ("v1",))))
    cases["output_stage"] = ocs

    # in_stats and fused_in_mod: one trunk activation [8,128,128,64]; γ and β
    # are channel slices of a group's [8,128,128,M] map, as on the main path;
    # route vec16 in both types (on x and on a channel slice), v1 (forced)
    # timed as previous; a ragged case (C = 24, 13×21 pixels, every base one
    # element past 16 bytes) on v1
    def trunk_x():
        return rn(B, 128, 128, 64, s=1.5, mean=0.5)

    def in_mod_inputs():
        gb = rn(B, 128, 128, 256, s=0.3)
        return trunk_x(), gb[..., 64:128], gb[..., 128:192]

    def ragged(*shape):
        return rn(*shape[:-1], shape[-1] + 1, s=1.5, mean=0.5)[..., 1:]

    def sums64(x):
        return x.double().sum(dim=(1, 2)), x.double().square().sum(dim=(1, 2))

    def in_mod_64(x, g, b):
        x, g, b = x.double(), g.double(), b.double()
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = (x - mean).square().mean(dim=(1, 2), keepdim=True)
        return (x - mean) * torch.rsqrt(var + 1e-5) * (1.0 + g) + b

    xs, gam, bet = in_mod_inputs()
    xr = ragged(3, 13, 21, 24)
    cases["in_stats"] = [
        KernelCase(
            "in_stats", lambda x=xs: in_stats(x), lambda x=xs: in_stats_plain(x),
            lambda x=xs: torch.var_mean(x.float(), dim=(1, 2)),
            nbytes(xs) + 2 * B * 64 * 4, 3 * xs.numel(),
            ref64=lambda x=xs: sums64(x), tol=1e-5, route=(in_stats, vec16),
            previous=lambda x=xs: stats_launch(x, "v1")[0],
            extra=lambda x=xs: vec16_checks(
                torch, dt, "in_stats", lambda: in_stats(x),
                lambda: stats_launch(x[:3])[1], 1),
            rotate=((xs,), lambda: (trunk_x(),))),
        KernelCase(
            "in_stats[channel slice]",
            lambda x=gam: in_stats(x), lambda x=gam: in_stats_plain(x), None,
            nbytes(xs) + 2 * B * 64 * 4, 3 * xs.numel(), main=False,
            ref64=lambda x=gam: sums64(x), tol=1e-5, route=(in_stats, vec16),
            rotate=((gam,), lambda: in_mod_inputs()[1:2])),
        KernelCase(
            "in_stats[ragged 13×21, C=24, unaligned]",
            lambda x=xr: in_stats(x), lambda x=xr: in_stats_plain(x), None,
            0, 0, main=False, timed=False, ref64=lambda x=xr: sums64(x),
            tol=1e-5, route=(in_stats, v1))]
    rg = tuple(ragged(3, 13, 21, 24) for _ in range(3))
    cases["fused_in_mod"] = [
        KernelCase(
            "fused_in_mod", lambda x=xs, g=gam, b=bet: fused_in_mod(x, g, b),
            lambda x=xs, g=gam, b=bet: fused_in_mod_plain(x, g, b), None,
            4 * nbytes(xs), 8 * xs.numel(),
            ref64=lambda x=xs, g=gam, b=bet: in_mod_64(x, g, b),
            route=(fused_in_mod, vec16),
            previous=lambda x=xs, g=gam, b=bet: in_mod_launch(x, g, b,
                                                              route="v1")[0],
            extra=lambda x=xs, g=gam, b=bet: vec16_checks(
                torch, dt, "fused_in_mod", lambda: fused_in_mod(x, g, b),
                lambda: in_mod_launch(x[:3], g[:3], b[:3])[1], 2),
            rotate=((xs, gam, bet), in_mod_inputs)),
        KernelCase(
            "fused_in_mod[ragged 13×21, C=24, unaligned]",
            lambda a=rg: fused_in_mod(*a), lambda a=rg: fused_in_mod_plain(*a),
            None, 0, 0, main=False, timed=False,
            ref64=lambda a=rg: in_mod_64(*a), route=(fused_in_mod, v1))]

    # head_dot: g4 [257, 257, 8, 512] (HWNC view of the producer's BHWC)
    g4 = rn(B, 257, 257, 512, s=0.5).permute(1, 2, 0, 3)
    w64 = rn(3, 3, 512, 64, s=0.02)
    b64 = rn(64, s=0.1, dtype=torch.float32)
    pb = rn(512, s=0.1)
    # yardstick: one cuDNN conv over the already-activated NCHW input
    g4_act = F.leaky_relu(g4.permute(2, 3, 0, 1) + pb[None, :, None, None], 0.2)
    w64_oihw = w64.permute(3, 2, 0, 1).contiguous()

    def head_lib():
        return F.conv2d(g4_act, w64_oihw, padding=1)
    head_route = (head_dot, {torch.bfloat16: "wgmma", torch.float32: "fp32"})
    cases["head_dot"] = [KernelCase(
        "head_dot",
        lambda: head_dot(g4, w64, b64, 256, pb),
        lambda g=g4, w=w64, b=b64, p=pb: head_dot_plain(g, w, b, 256, p),
        head_lib,
        nbytes(g4, w64, b64, pb) + 256 * B * 256 * 64 * g4.element_size(),
        2 * B * 256 * 256 * 9 * 512 * 64,
        previous=lambda: launch_igemm(g4, w64, b64, 256, pb),
        route=head_route)]
    # ragged: tiles cut by both edges, dead columns in memory, two slices
    for label, with_pb in (("pre_bias", True), ("raw", False)):
        rg4 = rn(3, 14, 24, 128, s=0.5).permute(1, 2, 0, 3)
        rw, rb = rn(3, 3, 128, 64, s=0.03), rn(64, s=0.1, dtype=torch.float32)
        rpb = rn(128, s=0.1) if with_pb else None
        cases["head_dot"].append(KernelCase(
            f"head_dot[ragged 13×21 of 24, C4=128, {label}]",
            lambda a=(rg4, rw, rb, 21, rpb): head_dot(*a),
            lambda g=rg4, w=rw, b=rb, p=rpb: head_dot_plain(g, w, b, 21, p),
            None, 0, 0, main=False, route=head_route, timed=False))

    # packed_g123: up1 chain (x [128,128,8,256], pre_act) and tail chain
    # (packed producer [129,129,8,512], phases + pre_act + pre_bias); and
    # ragged ones at B = 3 (odd extents under one column tile, two and four
    # 64-channel slices), the tail-like one with data planted in the dead
    # packed row and column, which the interleave drops
    pcs = []
    packed_route = (packed_g123, {torch.bfloat16: "wgmma",
                                  torch.float32: "fp32"})
    for label, xshape, cin4, phases, main in (
            ("up1", (B, 128, 128, 256), 256, False, True),
            ("tail", (B, 129, 129, 512), 128, True, True),
            ("ragged up1-like 13×21, B=3", (3, 13, 21, 256), 256, False, False),
            ("ragged tail-like 8×12 packed, B=3", (3, 8, 12, 512), 128, True,
             False)):
        x = rn(*xshape, s=0.5)
        if phases and not main:
            x[:, -1] = 9.0
            x[:, :, -1] = -9.0
        x = x.permute(1, 2, 0, 3)
        k1 = rn(2, 2, cin4, 128, s=1.0 / math.sqrt(4 * cin4))
        k2 = rn(2, 2, 128, 128, s=1.0 / math.sqrt(512))
        k3 = rn(2, 2, 128, 128, s=1.0 / math.sqrt(512))
        b1, b2, b3 = (rn(128, s=0.1) for _ in range(3))
        pbias = rn(cin4, s=0.1) if phases else None
        bb, hh, ww = xshape[:3]
        n, m = ((2 * (hh - 1) + 1, 2 * (ww - 1) + 1) if phases
                else (hh + 1, ww + 1))
        args = (x, k1, b1, k2, b2, k3, b3)
        kw = dict(pre_act=True, pre_bias=pbias, phases=phases)
        flops = 2 * bb * n * m * 4 * (cin4 * 128 + 2 * 128 * 128)
        pcs.append(KernelCase(
            f"packed_g123[{label}]",
            lambda a=args, k=kw: packed_g123(*a, **k),
            lambda a=args, k=kw: packed_g123_plain(*a, **k),
            None,
            nbytes(x, k1, k2, k3, b1, b2, b3,
                   *([pbias] if pbias is not None else []))
            + n * m * bb * 128 * x.element_size(),
            flops, main=main, timed=main, route=packed_route,
            previous=lambda a=args, k=kw: packed_igemm(*a, **k)))
    cases["packed_g123"] = pcs

    # packed_g123's k4 option (no path passes it): the up1 chain with the
    # absorbed ungated stage 4, k4 [2,2,128,512] (the up1 chain's next
    # conv, endosr/nn/depthnet.py:960-1003), stages 1-3 on their route and
    # stage 4 on the shared implicit GEMM
    x = rn(B, 128, 128, 256, s=0.5).permute(1, 2, 0, 3)
    k1 = rn(2, 2, 256, 128, s=1.0 / math.sqrt(1024))
    k2, k3 = (rn(2, 2, 128, 128, s=1.0 / math.sqrt(512)) for _ in range(2))
    k4 = rn(2, 2, 128, 512, s=1.0 / math.sqrt(512))
    b1, b2, b3 = (rn(128, s=0.1) for _ in range(3))
    b4 = rn(512, s=0.1)
    args = (x, k1, b1, k2, b2, k3, b3)
    kw = dict(pre_act=True, k4=k4, b4=b4)
    cases["packed_g123[k4]"] = [KernelCase(
        "packed_g123[k4 up1]",
        lambda a=args, k=kw: packed_g123(*a, **k),
        lambda a=args, k=kw: packed_g123_plain(*a, **k),
        None,
        nbytes(x, k1, k2, k3, k4, b1, b2, b3, b4)
        + 129 * 129 * B * 512 * x.element_size(),
        2 * B * 129 * 129 * 4 * (256 * 128 + 2 * 128 * 128 + 128 * 512),
        route=(packed_g123, {torch.bfloat16: ("wgmma", "k4_mma"),
                             torch.float32: ("fp32", "k4_fp32")}),
        previous=lambda a=args, k=kw: packed_igemm(*a, **k))]

    # style_blend_dot: the 7- and 6-block groups (M = 1792 / 1536)
    scs = []
    masks = (torch.rand((B, 128, 128, 90), generator=gen, device=dev)
             > 0.8).to(dt)
    blend_route = (style_blend_dot, {torch.bfloat16: "tc",
                                     torch.float32: "cuda_core"})
    for nblk in (7, 6):
        m = nblk * 2 * 128
        v = rn(B, 90, m, s=0.05)
        convs = tuple(rn(B, 128, 128, 128, s=0.3).permute(1, 2, 0, 3)
                      for _ in range(2 * nblk))
        bias = rn(m, s=0.1, dtype=torch.float32)
        cat = torch.cat([c.permute(2, 0, 1, 3) for c in convs], dim=-1)
        cat = cat.reshape(B, 128 * 128, m)
        sflat = masks.reshape(B, 128 * 128, 90)
        bias_dt = bias.to(dt)
        scs.append(KernelCase(
            f"style_blend_dot[M={m}]",
            lambda s=masks, vv=v, c=convs, b=bias: style_blend_dot(s, vv, c, b),
            lambda s=masks, vv=v, c=convs, b=bias: style_blend_plain(s, vv, c, b),
            lambda c=cat, s=sflat, vv=v, b=bias_dt:
                torch.baddbmm(c, s, vv).add_(b),
            nbytes(masks, v, bias, *convs) + 128 * 128 * B * m * masks.element_size(),
            2 * B * 128 * 128 * 90 * m,
            previous=lambda s=masks, vv=v, c=convs, b=bias:
                launch_blend_cuda_core(s, vv, c, b),
            route=blend_route))
    # ragged: 13×21 (a last pixel tile of 17 rows), c2 = 24 (a 128-channel
    # tile spans six convs), M = 264 (the third tile cut to 8 channels)
    rsh = (torch.rand((2, 13, 21, 90), generator=gen, device=dev) > 0.7).to(dt)
    rv, rb = rn(2, 90, 264, s=0.05), rn(264, s=0.1, dtype=torch.float32)
    rconvs = tuple(rn(2, 13, 21, 24, s=0.3).permute(1, 2, 0, 3)
                   for _ in range(11))
    scs.append(KernelCase(
        "style_blend_dot[ragged 13×21, c2=24, M=264]",
        lambda s=rsh, vv=rv, c=rconvs, b=rb: style_blend_dot(s, vv, c, b),
        lambda s=rsh, vv=rv, c=rconvs, b=rb: style_blend_plain(s, vv, c, b),
        None, 0, 0, main=False, route=blend_route, timed=False))
    cases["style_blend_dot"] = scs

    # style_blend_dot's hwbc option (no path passes it): the 7-block group
    # with shifted given as [H,W,B,J], the mask-conv producer's order
    m = 7 * 2 * 128
    masks_h = masks.permute(1, 2, 0, 3).contiguous()
    v = rn(B, 90, m, s=0.05)
    convs = tuple(rn(B, 128, 128, 128, s=0.3).permute(1, 2, 0, 3)
                  for _ in range(14))
    bias = rn(m, s=0.1, dtype=torch.float32)
    cat = torch.cat([c.permute(2, 0, 1, 3) for c in convs], dim=-1)
    cat = cat.reshape(B, 128 * 128, m)
    sflat = masks.reshape(B, 128 * 128, 90)
    cases["style_blend_dot[hwbc]"] = [KernelCase(
        f"style_blend_dot[hwbc M={m}]",
        lambda s=masks_h, vv=v, c=convs, b=bias: style_blend_dot(
            s, vv, c, b, hwbc=True),
        lambda s=masks_h, vv=v, c=convs, b=bias: style_blend_plain(
            s, vv, c, b, hwbc=True),
        lambda c=cat, s=sflat, vv=v, b=bias.to(dt):
            torch.baddbmm(c, s, vv).add_(b),
        nbytes(masks_h, v, bias, *convs)
        + 128 * 128 * B * m * masks_h.element_size(),
        2 * B * 128 * 128 * 90 * m,
        previous=lambda s=masks_h, vv=v, c=convs, b=bias:
            launch_blend_cuda_core(s, vv, c, b, hwbc=True),
        route=(style_blend_dot, {torch.bfloat16: "tc_hwbc",
                                 torch.float32: "cuda_core_hwbc"}))]

    # style_dot_hwbm: the same two groups on the masked path
    hcs = []
    style_route = (style_dot_hwbm, {torch.bfloat16: "tc",
                                    torch.float32: "cuda_core"})
    for nblk in (7, 6):
        m = nblk * 2 * 128
        v = rn(B, 90, m, s=0.05)
        sflat = masks.reshape(B, 128 * 128, 90)
        hcs.append(KernelCase(
            f"style_dot_hwbm[M={m}]",
            lambda s=masks, vv=v: style_dot_hwbm(s, vv),
            lambda s=masks, vv=v: style_dot_plain(s, vv),
            lambda s=sflat, vv=v: torch.bmm(s, vv),
            nbytes(masks, v) + 128 * 128 * B * m * masks.element_size(),
            2 * B * 128 * 128 * 90 * m,
            previous=lambda s=masks, vv=v: launch_cuda_core(s, vv),
            route=style_route))
    # ragged: a last pixel tile of 17 rows, an image base that is no multiple
    # of 16 bytes, the third N tile cut to 8 channels; dense values
    rsh, rv = rn(2, 13, 21, 90, s=0.5), rn(2, 90, 264, s=0.05)
    hcs.append(KernelCase(
        "style_dot_hwbm[ragged 13×21, M=264]",
        lambda s=rsh, vv=rv: style_dot_hwbm(s, vv),
        lambda s=rsh, vv=rv: style_dot_plain(s, vv),
        None, 0, 0, main=False, route=style_route, timed=False))
    cases["style_dot_hwbm"] = hcs

    # fused_o_branch and fused_modulation: the 13 trunk blocks' 26 SEANs on
    # one depth map [8,128,128,1] (hoist_chunk 0), K = 10 bins; checked
    # only: the wgmma route on tiles cut by both edges (B = 2, 13×21, N = 3,
    # 2C = 128), at 2C = 64 (40×70: a cut row tile and column tile), with a
    # large positive bm (a relu(bm) padding ring would show), and the mma
    # route at a ragged small shape (2C = 32, K = 4)
    ocs, mcs = [], []
    wg_routes = {torch.float32: "fp32", torch.bfloat16: "wgmma"}
    for label, (nb_, hh, ww), N, C2, K, bm_mean, want, main in (
            ("", (B, 128, 128), 26, 128, 10, 0.0, "wgmma", True),
            ("[ragged 13×21, 2C=128]", (2, 13, 21), 3, 128, 10, 0.0, "wgmma", False),
            ("[40×70, 2C=64]", (2, 40, 70), 5, 64, 10, 0.0, "wgmma", False),
            ("[large bm]", (1, 20, 30), 2, 128, 10, 5.0, "wgmma", False),
            ("[ragged 13×21]", (2, 13, 21), 3, 32, 4, 0.0, "mma", False)):
        d = torch.rand((nb_, hh, ww, 1), generator=gen, device=dev).to(dt)
        wm = rn(N, 9, C2, s=0.3)
        bm = (rn(N, C2, s=0.1).abs() + bm_mean).to(dt) if bm_mean else rn(N, C2, s=0.1)
        w2 = rn(N, 9, C2, C2, s=1.0 / math.sqrt(9 * C2))
        b2 = rn(N, C2, s=0.1)
        out_bytes = nb_ * hh * ww * N * C2 * d.element_size()
        wm_oihw = wm.permute(0, 2, 1).reshape(N * C2, 1, 3, 3).contiguous()
        w2_oihw = grouped_w2(w2, N, C2).contiguous()
        d_nchw = d.permute(0, 3, 1, 2)
        routes = {**wg_routes, torch.bfloat16: want}

        def obranch_lib(d_nchw=d_nchw, wm_oihw=wm_oihw, bm=bm, w2_oihw=w2_oihw,
                        b2=b2, N=N):
            a = F.relu(F.conv2d(d_nchw, wm_oihw, bm.reshape(-1), padding=1))
            return F.conv2d(a, w2_oihw, b2.reshape(-1), padding=1, groups=N)
        ocs.append(KernelCase(
            "fused_o_branch" + label,
            lambda a=(d, wm, bm, w2, b2): fused_o_branch(*a),
            lambda a=(d, wm, bm, w2, b2): fused_o_branch_plain(*a),
            obranch_lib, nbytes(d, wm, bm, w2, b2) + out_bytes,
            2 * nb_ * hh * ww * N * (9 * C2 + 9 * C2 * C2), main=main,
            route=(fused_o_branch, routes), timed=main,
            previous=(lambda a=(d, wm, bm, w2, b2): obranch_mma(*a)) if main else None))
        dmask = (torch.rand((nb_, hh, ww, K), generator=gen, device=dev)
                 > 0.8).to(dt)
        vmod = rn(nb_, N, 9 * K, C2, s=0.05)
        w2f = w2.reshape(N, 9 * C2, C2)
        margs = (d, dmask, wm, bm, w2f, vmod, b2)
        mcs.append(KernelCase(
            "fused_modulation" + label,
            lambda a=margs: fused_modulation(*a),
            lambda a=margs: fused_modulation_plain(*a),
            None, nbytes(d, dmask, wm, bm, w2f, vmod, b2) + out_bytes,
            2 * nb_ * hh * ww * N * (9 * C2 + (9 * C2 + 9 * K) * C2),
            main=main, route=(fused_modulation, routes), timed=main,
            previous=(lambda a=margs: mod_mma(*a)) if main else None))
    cases["fused_o_branch"], cases["fused_modulation"] = ocs, mcs

    # fused_tail: the raw g4 [257, 257, 8, 512] (HWBC view of the producer's
    # BHWC) with its producer bias, as the pallas_tail path calls it; the
    # dead last row and column hold data, which the kernel must gate
    t4 = rn(B, 257, 257, 512, s=0.5).permute(1, 2, 0, 3)
    wh = rn(3, 3, 512, 48, s=0.01)
    bh = rn(48, s=0.1, mean=0.5, dtype=torch.float32)
    tpb = rn(512, s=0.1)
    # yardstick: one cuDNN conv over the already-activated and gated input
    t4_act = F.leaky_relu(t4.permute(2, 3, 0, 1) + tpb[None, :, None, None], 0.2)
    t4_act[:, :, 256] = 0
    t4_act[:, :, :, 256] = 0
    t4_padded = F.pad(t4_act, (1, 0, 1, 0))
    del t4_act
    wh_oihw, bh_dt = wh.permute(3, 2, 0, 1).contiguous(), bh.to(dt)

    def tail_lib():
        pre = F.conv2d(t4_padded, wh_oihw, bh_dt)[..., :256]
        return F.pixel_shuffle(torch.clamp(pre, 0.0, 1.0), 4).float()
    tail_route = (fused_tail, {torch.bfloat16: "wgmma", torch.float32: "fp32"})
    cases["fused_tail"] = [KernelCase(
        "fused_tail",
        lambda a=(t4, wh, bh): fused_tail(*a, 0.0, 1.0, "hwbc", 256, tpb),
        lambda g=t4, w=wh, b=bh, p=tpb: fused_tail_plain(g, w, b, 0.0, 1.0,
                                                         "hwbc", 256, p),
        tail_lib, nbytes(t4, wh, bh, tpb) + B * 1024 * 3072 * 4,
        2 * B * 256 * 256 * 9 * 512 * 48,
        previous=lambda: tail_igemm(t4, wh, bh, 0.0, 1.0, "hwbc", 256, tpb),
        route=tail_route)]
    # ragged: h = 13 (not a multiple of 4) ≠ wout = 21 (not a multiple of
    # 64) of 24 columns in memory, C4 = 128 (two slices), B = 3
    for label, with_pb in (("pre_bias", True), ("raw", False)):
        rg4 = rn(3, 14, 24, 128, s=0.5)
        if not with_pb:        # activated and gated, as the function expects
            rg4 = torch.relu(rg4)
            rg4[:, 13] = 0
            rg4[:, :, 21:] = 0
        rg4 = rg4.permute(1, 2, 0, 3)
        rw, rbh = rn(3, 3, 128, 48, s=0.03), rn(48, s=0.1, mean=0.5, dtype=torch.float32)
        rpb = rn(128, s=0.1) if with_pb else None
        cases["fused_tail"].append(KernelCase(
            f"fused_tail[ragged 13×21 of 24, C4=128, {label}]",
            lambda a=(rg4, rw, rbh, 0.0, 1.0, "hwbc", 21, rpb): fused_tail(*a),
            lambda g=rg4, w=rw, b=rbh, p=rpb: fused_tail_plain(
                g, w, b, 0.0, 1.0, "hwbc", 21, p),
            None, 0, 0, main=False, route=tail_route, timed=False))

    # mid_shuffle: the ×8 tail's [8,128,128,512] → [8,256,256,128], and its
    # backward against the plain un-shuffle and autograd of the plain version
    zs = rn(B, 128, 128, 512)

    def shuffle_backward(z=zs):
        g = torch.randn((B, 256, 256, 128), generator=gen, device=dev).to(dt)
        mid_shuffle.routes = dict.fromkeys(mid_shuffle.routes, 0)
        with torch.enable_grad():
            za = z.clone().requires_grad_(True)
            mid_shuffle(za, 2).backward(g)
            zb = z.clone().requires_grad_(True)
            mid_shuffle_plain(zb, 2).backward(g)
        if not (torch.equal(za.grad, mid_unshuffle_plain(g, 2))
                and torch.equal(za.grad, zb.grad)):
            raise AssertionError(f"mid_shuffle backward {dt}: not bit-identical")
        if mid_shuffle.routes != {"vec16": 2, "scalar": 0}:
            raise AssertionError(f"mid_shuffle backward {dt}: routes "
                                 f"{mid_shuffle.routes}, want vec16")
        sc = shuffle_launch(g, 2, True, "scalar")[0]
        if not torch.equal(sc, za.grad):
            raise AssertionError(f"mid_shuffle scalar backward {dt}: differs")
        log(f"mid_shuffle backward {str(dt)[6:]}: route vec16, bit-identical "
            "to the plain un-shuffle, to autograd of the plain version and "
            "to the scalar route")
    cases["mid_shuffle"] = [KernelCase(
        "mid_shuffle", lambda z=zs: mid_shuffle(z, 2),
        lambda z=zs: mid_shuffle_plain(z, 2),
        lambda z=zs: mid_shuffle_plain(z, 2), 2 * nbytes(zs), 0, exact=True,
        extra=shuffle_backward,
        rotate=((zs,), lambda: (rn(B, 128, 128, 512),)),
        route=(mid_shuffle, {torch.bfloat16: "vec16", torch.float32: "vec16"}),
        previous=lambda z=zs: shuffle_launch(z, 2, False, "scalar")[0])]
    return cases


def device_kernels(torch, fn, tries=3):
    """Names of the device kernels one call of ``fn`` launches, read by
    ``torch.profiler`` (after one call outside it). A profile that records
    no device event at all (the profiler's device tracing did not start:
    seen once on the card, in the second profile of a process) is taken
    again, up to ``tries`` profiles."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            return names
    return names


def vec16_checks(torch, dt, name, call, b_view, n_kernels):
    """The vec16 route of ``in_stats`` or ``fused_in_mod``: ``n_kernels``
    device kernels a call, two calls bit-equal, and the ticket counters all
    0 after a call with B = 8 and then one with B = 3 (``b_view``)."""
    from endosr_torch.kernels.in_stats import tickets

    def flat(r):
        return r if isinstance(r, tuple) else (r,)

    first, second = flat(call()), flat(call())
    if not all(torch.equal(u, v) for u, v in zip(first, second)):
        raise AssertionError(f"{name} {dt}: two vec16 calls differ")
    route = b_view()
    torch.cuda.synchronize()
    t = tickets(first[0].device, 8)
    if route != "vec16" or bool(t.any()):
        raise AssertionError(f"{name} {dt}: route {route}, tickets {t.tolist()} "
                             "after B = 8 and B = 3")
    kernels = device_kernels(torch, call)
    if len(kernels) != n_kernels:
        raise AssertionError(f"{name} {dt}: {len(kernels)} device kernels a "
                             f"call ({kernels}), want {n_kernels}")
    log(f"{name} vec16 {str(dt)[6:]}: two calls bit-equal; tickets 0 after "
        f"B = 8 and B = 3; {n_kernels} device kernel(s) a call: "
        + ", ".join(k[:60] for k in kernels))


CLAMPS = ((0.0, 1.0), (0.001, 0.999))


def clamp_checks(torch, dt, name, launch, plain, routes=("vec16", "v1")):
    """An output stage on each of ``routes`` (``launch(lo, hi, route)`` →
    (output, route)) at the clamp bounds of ``CLAMPS``, bit-identical to
    ``plain(lo, hi)``: the kernels round the bounds to the storage type as
    ``torch.clamp`` does (0.999 is 1.0 in bf16)."""
    for lo, hi in CLAMPS:
        want = plain(lo, hi)
        for route in routes:
            got, took = launch(lo, hi, route)
            if took != route or not torch.equal(got, want):
                raise AssertionError(
                    f"{name} {dt} route {took} at clamp {lo}, {hi}: not "
                    f"bit-identical (max |Δ| {rel_err(got, want)[0]})")
    log(f"{name} {str(dt)[6:]}: routes {', '.join(routes)} bit-identical to "
        "the plain version at clamp bounds "
        + " and ".join(f"{lo}/{hi}" for lo, hi in CLAMPS))


SOURCES = {
    "packed_g123": ("endosr_torch/csrc/packed_chain.cu",
                    "endosr/kernels/packed_chain.py:438"),
    "style_blend_dot": ("endosr_torch/csrc/style_dot.cu",
                        "endosr/kernels/style_dot.py:284"),
    "head_dot": ("endosr_torch/csrc/head_dot.cu",
                 "endosr/kernels/head_dot.py:283"),
    "output_stage_x8": ("endosr_torch/csrc/output_stage.cu",
                        "endosr/kernels/output_stage.py:275"),
    "output_stage": ("endosr_torch/csrc/output_stage.cu",
                     "endosr/kernels/output_stage.py:316"),
    "style_dot_hwbm": ("endosr_torch/csrc/style_dot.cu",
                       "endosr/kernels/style_dot.py:111"),
    "fused_in_mod": ("endosr_torch/csrc/fused_in_mod.cu",
                     "endosr/kernels/fused_in_mod.py:95"),
    "in_stats": ("endosr_torch/csrc/in_stats.cu",
                 "endosr/kernels/in_stats.py:47"),
    "fused_o_branch": ("endosr_torch/csrc/fused_mod.cu",
                       "endosr/kernels/fused_obranch.py:146"),
    "fused_modulation": ("endosr_torch/csrc/fused_mod.cu",
                         "endosr/kernels/fused_mod.py:152"),
    "fused_tail": ("endosr_torch/csrc/fused_tail.cu",
                   "endosr/kernels/fused_tail.py:238"),
    "mid_shuffle": ("endosr_torch/csrc/shuffle_mid.cu",
                    "endosr/kernels/shuffle_mid.py:94"),
    # the two kernel options no path passes (their launches are 0)
    "packed_g123[k4]": ("endosr_torch/csrc/packed_chain.cu",
                        "endosr/kernels/packed_chain.py:438"),
    "style_blend_dot[hwbc]": ("endosr_torch/csrc/style_dot.cu",
                              "endosr/kernels/style_dot.py:284"),
}


def check_kernels(torch):
    """Phase 3: kernels against plain versions; returns the JSON rows
    (without launches)."""
    rows = {}
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        gen = torch.Generator(device="cuda").manual_seed(0)
        cases = make_cases(torch, dt, gen)
        for name, cs in cases.items():
            worst_abs = 0.0
            tot = {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "library_ms": 0.0 if cs[0].library else None}
            if cs[0].previous:
                tot["previous_ms"] = 0.0
            for c in cs:
                if c.route:
                    fn, by_dt = c.route
                    fn.routes = dict.fromkeys(fn.routes, 0)
                got = c.kernel()
                torch.cuda.synchronize()
                took = by_dt[dt] if c.route else ()
                took = (took,) if isinstance(took, str) else took
                if c.route and fn.routes != {**dict.fromkeys(fn.routes, 0),
                                             **dict.fromkeys(took, 1)}:
                    raise AssertionError(f"{c.name} {dt}: routes {fn.routes}, "
                                         f"want one launch on each of {took}")
                ctol = c.tol or tol
                if c.exact:
                    ref = c.plain()
                    if not torch.equal(got, ref):
                        raise AssertionError(f"{c.name} {dt}: not bit-identical "
                                             f"(max |Δ| {rel_err(got, ref)[0]})")
                    err_abs, err_rel = 0.0, 0.0
                elif dt == torch.float32 or c.tol:
                    # float64 on the same values: the plain version, or the
                    # case's own reference
                    ref = c.ref64() if c.ref64 else _plain_f64(torch, c)
                    err_abs, err_rel = rel_err(got, ref)
                else:
                    ref = c.plain()
                    err_abs, err_rel = rel_err(got, ref)
                log(f"{c.name} {str(dt)[6:]}: max|Δ| {err_abs:.3e} "
                    f"rel {err_rel:.3e} (tol {ctol:g})")
                if not err_rel <= ctol:
                    raise AssertionError(f"{c.name} {dt}: rel err {err_rel} > {ctol}")
                worst_abs = max(worst_abs, err_abs)
                del got, ref
                if c.extra:
                    c.extra()
                if dt == torch.bfloat16 and c.timed:
                    if c.rotate:
                        sets = rotation(*c.rotate)

                        def timer(f, sets=sets):
                            return graph_ms(f, sets)
                    else:
                        timer = cuda_ms
                    ms = timer(c.kernel)
                    call = cuda_ms(c.kernel) if c.rotate else ms
                    pms = timer(c.plain)
                    lms = timer(c.library) if c.library else None
                    prev = timer(c.previous) if c.previous else None
                    bms, by = bound_ms(c.bytes, c.flops)
                    how = (f"graph of ≥ {N_GRAPH} over {len(sets)} input sets"
                           if c.rotate else "one call")
                    log(f"  {c.name} bf16 ({how}): kernel {ms:.4f} ms, call "
                        f"{call:.4f} ms, plain {pms:.4f} ms, "
                        f"library {'-' if lms is None else f'{lms:.4f} ms'}, "
                        f"bound {bms:.4f} ms ({by}; {c.bytes / 1e6:.1f} MB, "
                        f"{c.flops / 1e9:.1f} GFLOP)"
                        + (f", previous route {prev:.4f} ms" if prev else ""))
                    if c.rotate:
                        del sets, timer
                    if not c.main:
                        continue
                    if prev is not None:
                        tot["previous_ms"] += prev
                    tot["ms"] += ms
                    tot["call_ms"] += call
                    tot["plain_ms"] += pms
                    tot["bound_ms"] += bms
                    if lms is not None:
                        tot["library_ms"] += lms
                    tot["bound_by"] = by
                    tot["timing"] = "graph" if c.rotate else "call"
            rows.setdefault(name, {"max_abs_err": {}})
            rows[name]["max_abs_err"][str(dt)[6:]] = worst_abs
            if dt == torch.bfloat16:
                rows[name].update(tot)
                if "previous_ms" in tot:
                    lib = tot["library_ms"]
                    vs_lib = ("no library call" if lib is None else
                              f"library_ms {lib:.4f}, {tot['ms'] / lib:.2f}× "
                              "the library call")
                    log(f"{name} bf16 at the main path's shapes: ms "
                        f"{tot['ms']:.4f}, previous_ms {tot['previous_ms']:.4f}, "
                        f"bound_ms {tot['bound_ms']:.4f}, plain_ms "
                        f"{tot['plain_ms']:.4f} ({vs_lib}, "
                        f"{tot['ms'] / tot['bound_ms']:.2f}× the bound)")
        del cases
        torch.cuda.empty_cache()
    return rows


def _plain_f64(torch, case):
    """Evaluate a case's plain version on float64 copies of its inputs."""
    fn = case.plain
    defaults = fn.__defaults__ or ()

    def up(a):
        if torch.is_tensor(a) and a.is_floating_point():
            return a.double()
        if isinstance(a, tuple):
            return tuple(up(x) for x in a)
        if isinstance(a, dict):
            return {k: up(v) for k, v in a.items()}
        return a

    return fn(*(up(d) for d in defaults))


def ptxas_usage(log_text, kernel):
    """What ``ptxas -v`` said of the entry function whose mangled name
    contains ``kernel``: registers, static shared memory, spills and any
    remark (its dynamic shared memory is set at launch)."""
    said = []
    lines = log_text.splitlines()
    for i, line in enumerate(lines):
        if kernel not in line:
            continue
        if "Compiling entry function" in line:
            said += [x.strip() for x in lines[i + 1:i + 4]
                     if "registers" in x or "spill" in x]
        elif "Compiling" not in line and "Function properties" not in line:
            said.append(line.strip())       # a remark that names the kernel
    if not said:
        raise AssertionError(f"no ptxas record of {kernel}")
    return " | ".join(x.replace("ptxas info    : ", "") for x in said)


def flagship_opt(precision, scale=8, bucket=0, **net):
    """The flagship DepthNet serving options; ``bucket=None`` leaves
    ``eval_bucket_multiple`` unset (the default, 32); ``net`` adds
    ``network_G`` keys."""
    opt = {
        "is_train": False, "model": "sftmd_depthCond", "scale": scale,
        "precision": precision,
        "datasets": {"test": {"depthMaskNum": 10}},
        "network_G": {"which_model_G": "DepthNet", "in_nc": 3, "out_nc": 3,
                      "nf": 64, "nb": 16, "depth_latent_ch": 256,
                      "which_ResBlk_depth": list(range(14)),
                      "use_trainable_params": True, **net},
        "path": {}, "train": {"manual_seed": 0},
    }
    if bucket is not None:
        opt["eval_bucket_multiple"] = bucket
    return opt


def small_forwards(torch):
    """Phase 4: reduced DepthNets through the kernels (fp32) vs the same
    weights through the plain versions on the CPU."""
    import torch.nn.functional as F

    from endosr_torch.nn.depthnet import DepthNet
    from endosr_torch.nn.networks import DEPTHNET_PRESETS
    from endosr_torch.ops.masks import pool_mask_np
    from endosr_torch.utils.port_params import seeded_init

    plain = DEPTHNET_PRESETS["plain"]
    base = dict(nb=6, depth_latent_ch=16, depth_range_num=4, style_chunk=2)
    every = (0, 1, 2, 3, 4, 5)
    cases = [
        ("x8", dict(scale=8, which_resblk_depth=(0, 1, 2)), None),
        ("x2", dict(scale=2, which_resblk_depth=every), None),
        ("x3", dict(scale=3, which_resblk_depth=every), None),
        ("x4", dict(scale=4, which_resblk_depth=(0, 1, 2)), None),
        ("x4 fused_epilogue", dict(scale=4, which_resblk_depth=(0, 1, 2),
                                   fused_epilogue=True, in_stats="kernel"), None),
        ("x8 valid_hw", dict(scale=8, which_resblk_depth=(0, 1, 2)), (29, 26)),
        ("x8 pallas_obranch", dict(scale=8, which_resblk_depth=(0, 1, 2),
                                   pallas_obranch=True), None),
        ("x8 pallas_obranch valid_hw (the masked hoisted route)",
         dict(scale=8, which_resblk_depth=(0, 1, 2), pallas_obranch=True),
         (29, 26)),
        ("x8 fused_modulation", dict(scale=8, which_resblk_depth=(0, 1, 2),
                                     fused_modulation=True, hoist_chunk=2),
         None, (28, 20)),
        ("x8 pallas_tail", dict(scale=8, which_resblk_depth=(0, 1, 2),
                                pallas_tail=True), None, (32, 24)),
        ("x8 dense tail", dict(scale=8, which_resblk_depth=(0, 1, 2),
                               packed_tail=False), None),
        ("x8 preset plain", dict(scale=8, which_resblk_depth=(0, 1, 2),
                                 **plain), None),
        ("x4 preset plain, depth block at nb-1", dict(
            scale=4, which_resblk_depth=(0, 1, 5), **plain), None),
    ]
    g = torch.Generator().manual_seed(1)
    for label, kw, valid, *size in cases:   # size: an unpadded (h, w)
        kw = {**base, **kw}
        cpu = seeded_init(DepthNet(**kw, device="cpu"), 0)
        gpu = DepthNet(**kw, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        h, w = valid or (size[0] if size else (32, 32))
        x = torch.rand((2, h, w, 3), generator=g)
        d = torch.rand((2, h, w, 1), generator=g)
        m = (torch.rand((2, h, w, 4), generator=g) > 0.6).float()
        extra = {}
        if valid:
            pm = pool_mask_np(m.numpy(), (((h + 1) // 2 + 1) // 2,
                                          ((w + 1) // 2 + 1) // 2), (8, 8))
            pad = (0, 0, 0, 32 - w, 0, 32 - h)
            x, d, m = (F.pad(t, pad) for t in (x, d, m))
            extra = dict(valid_hw=valid, pool_mask=torch.from_numpy(pm))
        with torch.inference_mode():         # forwards, as serving runs them
            want = cpu(x, d, m, **extra)
            got = gpu(x.cuda(), d.cuda(), m.cuda(),
                      **{k: v.cuda() if torch.is_tensor(v) else v
                         for k, v in extra.items()}).cpu()
        s = kw["scale"]
        err = float((got - want)[:, :h * s, :w * s].abs().max())
        log(f"small DepthNet {label} fp32, kernels on the card vs plain on "
            f"the CPU: max|Δ| {err:.3e} (tol 2e-4)")
        if not err <= 2e-4:
            raise AssertionError(f"small forward {label} differs: {err}")


def psnr(a, b):
    mse = float(((a.double() - b.double()) ** 2).mean())
    return 10 * math.log10(1.0 / mse) if mse > 0 else float("inf")


EXACT_ROUTES = {"head_dot": "fp32", "style_dot_hwbm": "cuda_core",
                "fused_tail": "fp32", "style_blend_dot": "cuda_core",
                "packed_g123": "fp32", "mid_shuffle": "vec16",
                "fused_o_branch": "fp32", "fused_modulation": "fp32",
                "in_stats": "vec16", "fused_in_mod": "vec16",
                "output_stage_x8": "vec16", "output_stage": "vec16"}


def zero_counts(counters):
    for c in counters:
        c.launches = 0
        if hasattr(c, "routes"):
            c.routes = dict.fromkeys(c.routes, 0)


def serve(torch, counters, label, opt16, opt32, lr_hw, want, on_host,
          n_requests=2, also32=None, want_routes=None):
    """Phase 5, one full-width path: ``n_requests`` batch-8 requests of LQ
    ``lr_hw`` through ``FModelDepthCond(opt16)`` (bf16) with the launch
    counts of ``counters`` set to 0 just before and read just after; then
    the first request through ``opt32`` (fp32, same weights) for the PSNR,
    and through ``also32`` = (label, options, tolerance), whose fp32 output
    must equal ``opt32``'s. ``want_routes``: {wrapper name: route} that all
    of that wrapper's launches of the bf16 requests must have taken; the
    fp32 request must take ``EXACT_ROUTES``. ``on_host``: requests are numpy
    arrays, as a data loader hands them over. Returns (per-request seconds,
    launches)."""
    import numpy as np

    from endosr_torch.models.f_depthcond import FModelDepthCond
    from endosr_torch.ops.masks import depth_masks, depth_masks_np

    h, w = lr_hw
    s = opt16["scale"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    rng = np.random.default_rng(2)

    def request():
        if on_host:
            dep = rng.random((8, h, w, 1), dtype=np.float32)
            return {"LQ": rng.random((8, h, w, 3), dtype=np.float32),
                    "Depth": dep,
                    "DepthMaskList": np.stack(
                        [depth_masks_np(d, True, 10) for d in dep])}
        lq = torch.rand((8, h, w, 3), generator=gen, device="cuda")
        dep = torch.rand((8, h, w, 1), generator=gen, device="cuda")
        return {"LQ": lq, "Depth": dep,
                "DepthMaskList": depth_masks(dep[..., 0], True, 10)}

    t0 = time.perf_counter()
    model = FModelDepthCond(opt16)
    log(f"[{label}] FModelDepthCond bf16 built in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.netG.parameters()):,} parameters)")
    reqs = [request() for _ in range(n_requests)]
    model.feed_data(reqs[0])
    model.test()                                   # warm-up request
    torch.cuda.synchronize()

    zero_counts(counters)
    lat, outs = [], []
    for r in reqs:
        t = time.perf_counter()
        model.feed_data(r)
        sr = model.test()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        outs.append(sr)
    launches = {c.__name__: c.launches for c in counters}
    routes = {c.__name__: dict(c.routes) for c in counters
              if hasattr(c, "routes")}

    shape = (8, h * s, w * s, 3)
    for k, sr in enumerate(outs):
        if tuple(sr.shape) != shape or sr.dtype != torch.float32:
            raise AssertionError(f"[{label}] request {k}: SR "
                                 f"{tuple(sr.shape)} {sr.dtype}")
        if not bool(torch.isfinite(sr).all()):
            raise AssertionError(f"[{label}] request {k}: non-finite SR")
        lo, hi = float(sr.min()), float(sr.max())
        if lo < 0.0 or hi > 1.0:
            raise AssertionError(f"[{label}] request {k}: SR outside [0,1]: "
                                 f"{lo}, {hi}")
        log(f"[{label}] request {k}: SR {list(shape)} fp32, range "
            f"[{lo:.4f}, {hi:.4f}], mean {float(sr.mean()):.4f}")
    for c in counters:
        per = want.get(c.__name__, 0)
        if launches[c.__name__] != per * n_requests:
            raise AssertionError(
                f"[{label}] {c.__name__}: {launches[c.__name__]} launches in "
                f"{n_requests} forwards, want {per} each")

    for name, route in (want_routes or {}).items():
        took = {**dict.fromkeys(routes[name], 0), route: launches[name]}
        if routes[name] != took or not launches[name]:
            raise AssertionError(f"[{label}] {name} routes {routes[name]}, "
                                 f"want {took}")
        log(f"[{label}] {name}: {launches[name]} launches, all on route "
            f"{route!r}")

    sr16 = outs[0].clone()
    del outs
    sd = model.netG.state_dict()
    del model
    torch.cuda.empty_cache()

    def fp32_output(opt):
        m32 = FModelDepthCond(opt)
        m32.netG.load_state_dict(sd)
        m32.feed_data(reqs[0])
        return m32.test().clone()

    zero_counts(counters)
    sr32 = fp32_output(opt32)
    for c in counters:
        if not hasattr(c, "routes"):
            continue
        exact = EXACT_ROUTES[c.__name__]
        took = {**dict.fromkeys(c.routes, 0), exact: c.launches}
        if c.routes != took:
            raise AssertionError(f"[{label}] fp32 request: {c.__name__} routes "
                                 f"{c.routes}, want {took}")
    db = psnr(sr16, sr32)
    log(f"[{label}] bf16 vs fp32 SR PSNR on the same weights: {db:.2f} dB "
        f"(min 40)")
    if not db >= 40.0:
        raise AssertionError(f"[{label}] bf16 vs fp32 PSNR {db} < 40 dB")
    if also32:
        what, opt, tol = also32
        err = float((fp32_output(opt) - sr32).abs().max())
        log(f"[{label}] fp32 output vs {what}: max|Δ| {err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"[{label}] differs from {what}: {err}")
    torch.cuda.empty_cache()
    med = sorted(lat)[len(lat) // 2]
    log(f"[{label}] batch 8, LQ {h}×{w} → SR {h * s}×{w * s}, bf16; "
        f"per-request latency " + ", ".join(f"{x * 1e3:.2f}" for x in lat)
        + f" ms; median {med * 1e3:.2f} ms = {8 / med:.2f} frames/s")
    return lat, launches


def serving_paths(torch, counters):
    """The full-width paths; returns {label: launches}."""
    fused = dict(net_kw={"fused_epilogue": True, "in_stats": "kernel"})
    plain32 = ("preset: plain", flagship_opt("fp32", preset="plain"), 2e-4)
    tail = {"packed_g123": 2, "head_dot": 1, "output_stage_x8": 1}

    def routes(want):
        fast = {"head_dot": "wgmma", "fused_tail": "wgmma",
                "style_blend_dot": "tc", "style_dot_hwbm": "tc",
                "packed_g123": "wgmma", "fused_o_branch": "wgmma",
                "fused_modulation": "wgmma", "in_stats": "vec16",
                "fused_in_mod": "vec16", "output_stage_x8": "vec16",
                "output_stage": "vec16"}
        return {k: r for k, r in fast.items() if k in want}

    def x8(label, want, **net):
        return dict(label=label, opt16=flagship_opt("bf16", **net),
                    opt32=flagship_opt("fp32", **net), lr_hw=(128, 128),
                    on_host=False, want=want, also32=plain32,
                    want_routes=routes(want))
    paths = [
        dict(x8("x8 unbucketed", {"style_blend_dot": 2, **tail}), n_requests=3),
        x8("x8 pallas_obranch", {"fused_o_branch": 1, **tail},
           net_kw={"pallas_obranch": True}),
        x8("x8 fused_modulation", {"fused_modulation": 1, **tail},
           net_kw={"fused_modulation": True}),
        x8("x8 pallas_tail",
           {"style_blend_dot": 2, "packed_g123": 2, "fused_tail": 1},
           net_kw={"pallas_tail": True}),
        dict(label="x8 preset plain",
             opt16=flagship_opt("bf16", preset="plain"),
             opt32=flagship_opt("fp32", preset="plain"), lr_hw=(128, 128),
             on_host=False, want={}),
        dict(label="x8 bucketed", opt16=flagship_opt("bf16", bucket=None),
             opt32=flagship_opt("fp32", bucket=None), lr_hw=(120, 112),
             on_host=True, want={"style_dot_hwbm": 2, "output_stage": 1},
             want_routes=routes({"style_dot_hwbm", "output_stage"}),
             also32=("the unbucketed forward", flagship_opt("fp32"), 1e-4)),
        dict(label="x4 fused_epilogue",
             opt16=flagship_opt("bf16", 4, None, **fused),
             opt32=flagship_opt("fp32", 4, None, **fused), lr_hw=(128, 128),
             on_host=False,
             want={"fused_in_mod": 26, "in_stats": 26, "style_blend_dot": 2,
                   "output_stage_x8": 1},
             want_routes=routes({"style_blend_dot", "in_stats",
                                 "fused_in_mod", "output_stage_x8"}),
             also32=("the chained epilogue", flagship_opt("fp32", 4, 0), 2e-4)),
    ]
    return {p["label"]: serve(torch, counters, **p)[1] for p in paths}


TRAIN_STEPS = 4
TRAIN_WANT = {"packed_g123": 2, "style_blend_dot": 2, "head_dot": 1,
              "output_stage_x8": 1}
BF16_VS_PLAIN = 2      # × plain PyTorch bf16's own distance from the fp32 step
GRAD_NOISE = 4         # × the plain version's own change under a one-ulp move
GRAD_FLOOR = 2e-4      # the repo's parity bar, norm-relative
GRAD_NREL_ALL = 2e-4   # all gradients as one vector, at least
ZERO_GRAD_FLOOR = 1e-7  # a zero true gradient's residue, of the largest, at least
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -4}


def _before_instance_norm(name):
    """A depth block's conv biases: an InstanceNorm follows each, so their
    true gradient is zero and both sides hold rounding only."""
    return name.startswith("netG.depth-residual") and name.endswith(
        (".conv1.0.bias", ".conv2.0.bias"))


def _step_params(model):
    """(name, parameter) of everything a training step updates: the
    generator and the dynamic loss's weights, and the co-training model's
    FCN (``segNet.<name>``)."""
    yield from model.named_train_parameters()
    if getattr(model, "segNet", None) is not None:
        yield from model.named_seg_parameters()


def _grads(model):
    """The model's gradients, copied to the host (so that keeping them does
    not count in the step's peak device memory)."""
    return {k: p.grad.cpu() for k, p in _step_params(model)}


def _nrel(got, want):
    """‖got − want‖ / ‖want‖ over every tensor of two gradient dicts."""
    num = sum(float((got[k] - w).square().sum()) for k, w in want.items())
    den = sum(float(w.square().sum()) for w in want.values())
    return (num / den) ** 0.5


def _train_from(torch, opt, start, batch, steps):
    """``steps`` steps of FModelDepthCond(opt) from the parameters ``start``
    on ``batch``: (l_all a step, the first step's gradients)."""
    from endosr_torch.models.f_depthcond import FModelDepthCond

    m = FModelDepthCond(opt)
    with torch.no_grad():
        for k, p in m.named_train_parameters():
            p.copy_(start[k])
    m.feed_data(batch)
    losses, first = [], None
    for n in range(steps):
        losses.append(m.optimize_parameters(n)["l_all"])
        if first is None:
            first = _grads(m)
    del m
    torch.cuda.empty_cache()
    return losses, first


def train_flagship(torch, counters):
    """Phase 6a: the flagship training step (bf16, batch 8, LQ 128² → GT
    1024², the ×8 YAML's ``train:`` block), ``TRAIN_STEPS`` steps on one
    seeded uint8 batch, the launch counts set to 0 just before and read
    just after. Then the same steps from the same weights in fp32 and in
    bf16 with ``preset: plain`` (no kernel): the first step's loss and
    gradients (all tensors, norm-relative) may be ``BF16_VS_PLAIN``× as far
    from the fp32 step's as plain PyTorch bf16's are. Returns (launches,
    ms a step after the first, peak GiB, the bf16 readings)."""
    from endosr_torch.models.f_depthcond import FModelDepthCond
    from endosr_torch.models.recipes import x8_train_opt
    from endosr_torch.ops.masks import depth_masks

    t0 = time.perf_counter()
    model = FModelDepthCond(x8_train_opt("bf16"))
    log(f"[train x8] FModelDepthCond bf16 (is_train) built in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for _, p in model.named_train_parameters()):,} "
        "trainable parameters)")
    start = {k: p.detach().cpu() for k, p in model.named_train_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(3)

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=gen, device="cuda",
                             dtype=torch.uint8)

    dep = torch.rand((8, 128, 128, 1), generator=gen, device="cuda")
    batch = {"LQ": u8(8, 128, 128, 3), "GT": u8(8, 1024, 1024, 3),
             "Depth": dep,
             "DepthMaskList": depth_masks(dep[..., 0], False, 10).to(
                 torch.uint8)}
    model.feed_data(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    losses, secs, first = [], [], None
    for n in range(TRAIN_STEPS):
        t = time.perf_counter()
        logs = model.optimize_parameters(n)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(logs["l_all"])
        if first is None:
            first = _grads(model)
        log(f"[train x8] step {n + 1}: l_all {logs['l_all']:.6f} (l_pix "
            f"{logs['l_pix']:.6f}, l_dynamic {logs['l_dynamic']:.6f}), lr "
            f"{model.optimizer_G.param_groups[0]['lr']:.6g}, "
            f"{secs[-1] * 1e3:.1f} ms")
    launches = {c.__name__: c.launches for c in counters}
    routes = {c.__name__: dict(c.routes) for c in counters
              if hasattr(c, "routes")}
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model
    torch.cuda.empty_cache()
    for c in counters:
        want = TRAIN_WANT.get(c.__name__, 0) * TRAIN_STEPS
        if launches[c.__name__] != want:
            raise AssertionError(f"[train x8] {c.__name__}: "
                                 f"{launches[c.__name__]} launches in "
                                 f"{TRAIN_STEPS} steps, want {want}")
    fast = {"packed_g123": "wgmma", "style_blend_dot": "tc",
            "head_dot": "wgmma", "output_stage_x8": "vec16"}
    for name, route in fast.items():
        took = {**dict.fromkeys(routes[name], 0), route: launches[name]}
        if routes[name] != took:
            raise AssertionError(f"[train x8] {name} routes {routes[name]}, "
                                 f"want {took}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"[train x8] losses {losses}: not finite, or "
                             f"step {TRAIN_STEPS}'s not below step 1's")
    ms = sum(secs[1:]) / (len(secs) - 1) * 1e3
    log(f"[train x8] {TRAIN_STEPS} steps, batch 8, LQ 128² → GT 1024², bf16: "
        + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
        + f" launches, routes {', '.join(f'{k} {v}' for k, v in fast.items())}; "
        f"{ms:.1f} ms a step (mean of steps 2–{TRAIN_STEPS}, host clock, "
        f"synchronised); peak device memory {peak:.2f} GiB; l_all "
        f"{losses[0]:.6f} → {losses[-1]:.6f}; {gpu_line()}")

    f32_losses, f32 = _train_from(torch, x8_train_opt("fp32"), start, batch,
                                  TRAIN_STEPS)
    pl_losses, pl = _train_from(torch, x8_train_opt("bf16", preset="plain"),
                                start, batch, TRAIN_STEPS)
    bf = {"loss_rel": abs(losses[0] - f32_losses[0]) / f32_losses[0],
          "grad_nrel": _nrel(first, f32),
          "plain_loss_rel": abs(pl_losses[0] - f32_losses[0]) / f32_losses[0],
          "plain_grad_nrel": _nrel(pl, f32)}
    per = sorted(((float((first[k] - w).norm() / w.norm().clamp_min(1e-30)),
                   k) for k, w in f32.items() if not _before_instance_norm(k)),
                 reverse=True)
    log(f"[train x8] l_all a step — bf16 kernels {losses}, fp32 {f32_losses}, "
        f"bf16 preset: plain {pl_losses}. Step 1 against fp32: loss "
        f"{bf['loss_rel']:.3g} relative (plain bf16 {bf['plain_loss_rel']:.3g}), "
        f"gradients {bf['grad_nrel']:.3g} norm-relative (plain bf16 "
        f"{bf['plain_grad_nrel']:.3g}; tol {BF16_VS_PLAIN}× plain bf16's); "
        "worst tensors " + ", ".join(f"{k} {e:.3g}" for e, k in per[:4]))
    for what in ("loss_rel", "grad_nrel"):
        if not bf[what] <= BF16_VS_PLAIN * bf[f"plain_{what}"]:
            raise AssertionError(
                f"[train x8] bf16 step 1 {what} against fp32 {bf[what]:.3g} > "
                f"{BF16_VS_PLAIN}× plain bf16's {bf[f'plain_{what}']:.3g}")
    bf.update(fp32_losses=f32_losses, plain_bf16_losses=pl_losses)
    return launches, ms, peak, bf


def _nudge_weights(torch, start, seed, device="cuda"):
    """``start`` (tensors on ``device``) with every parameter moved one
    fp32 ulp up or down (a seeded random sign each)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, p in start.items():
        up = torch.rand(p.shape, generator=gen, device=p.device) < 0.5
        out[k] = torch.where(up, torch.nextafter(p, p + 1.0),
                             torch.nextafter(p, p - 1.0))
    return out


def parity_batch(torch, scale, lr_hw, b=2, seed=4):
    """Phase 6b's fp32 batch: ``b`` images of seeded LQ ``lr_hw``, depth,
    GT at ``scale``× and masks drawn per bin (with one-hot bins the SEAN
    style gradients are sums that cancel to ~1e-6 of the largest)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h, w = lr_hw
    dep = torch.rand((b, h, w, 1), generator=gen, device="cuda")
    lq = torch.rand((b, h, w, 3), generator=gen, device="cuda")
    return {"LQ": lq,
            "GT": torch.rand((b, h * scale, w * scale, 3), generator=gen,
                             device="cuda"),
            "Depth": dep,
            "DepthMaskList": (torch.rand((b, h, w, 10), generator=gen,
                                         device="cuda") > 0.6).float()}


def parity_runs(torch, opt_of=None, batch=None, variants=None, plain=None,
                counters=None, model=None):
    """Phase 6b's steps: one fp32 step of each of ``variants`` ({label:
    ``network_G`` keys}; default: the default configuration as
    "kernels") and of ``preset: plain`` on the same weights and batch, then
    four of ``preset: plain`` nudged by one fp32 ulp: LQ up, LQ down,
    every weight up or down at random (two draws). ``opt_of(**net)``: the
    options (default: the ×8 recipe, fp32); ``batch`` (default: batch 2,
    LQ 128²); ``plain``: the ``network_G`` keys of the plain path (default
    ``preset: plain``). Each: logs, gradients, start and updated
    parameters, which output pixels were clamped, the step's peak device
    memory (GiB) and, with ``counters``, the launches and routes of the
    step (the counts set to 0 just before it and read just after).
    ``model``: the training model's class (default ``FModelDepthCond``)."""
    from endosr_torch.models.recipes import x8_train_opt

    if opt_of is None:
        opt_of = functools.partial(x8_train_opt, "fp32")
    if batch is None:
        batch = parity_batch(torch, 8, (128, 128))
    lq = batch["LQ"]
    plain = plain or {"preset": "plain"}
    runs, start = {}, None
    for label, net, feed, seed in (
            *((lab, kw, batch, None)
              for lab, kw in (variants or {"kernels": {}}).items()),
            ("plain", plain, batch, None),
            ("LQ + 1 ulp", plain,
             dict(batch, LQ=torch.nextafter(lq, lq + 1.0)), None),
            ("LQ - 1 ulp", plain,
             dict(batch, LQ=torch.nextafter(lq, lq - 1.0)), None),
            ("weights ± 1 ulp (a)", plain, batch, 7),
            ("weights ± 1 ulp (b)", plain, batch, 8)):
        runs[label] = parity_step(
            torch, opt_of(**net), start if seed is None
            else _nudge_weights(torch, start, seed), feed, counters,
            model=model)
        start = start or runs[label]["start"]
    return runs


def parity_step(torch, opt, start, feed, counters=None, deterministic=True,
                model=None):
    """One step of ``model(opt)`` (default ``FModelDepthCond``) from the
    parameters ``start``
    (None: its own seeded ones) on ``feed``, as ``parity_runs`` takes it.
    cuDNN takes its deterministic algorithms for the step unless
    ``deterministic`` is false: with its default ones two runs of the
    same step differ in their gradients (:func:`rerun_check`), and a
    reading of :func:`parity_readings` moves from one run to the next."""
    cudnn = torch.backends.cudnn
    was = cudnn.deterministic
    cudnn.deterministic = deterministic
    try:
        return _parity_step(torch, opt, start, feed, counters, model)
    finally:
        cudnn.deterministic = was


def _parity_step(torch, opt, start, feed, counters, model=None):
    from endosr_torch.models.f_depthcond import FModelDepthCond, u8_cast

    m = (model or FModelDepthCond)(opt)
    w0 = start or {k: p.detach().clone() for k, p in _step_params(m)}
    with torch.no_grad():
        for k, p in _step_params(m):
            p.copy_(w0[k])
        sr = m.netG(feed["LQ"], feed["Depth"], u8_cast(feed["DepthMaskList"]))
    m.feed_data(feed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters or [])
    t = time.perf_counter()
    logs = m.optimize_parameters()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    run = dict(
        logs=logs, start=w0, clamped=(sr == 0) | (sr == 1), grads=_grads(m),
        params={k: p.detach().clone() for k, p in _step_params(m)},
        secs=secs, peak_gib=peak,
        launches={c.__name__: c.launches for c in counters or []},
        routes={c.__name__: dict(c.routes) for c in counters or []
                if hasattr(c, "routes")})
    del m, sr
    torch.cuda.empty_cache()
    return run


def parity_readings(torch, runs, label, ref="plain", got="kernels"):
    """Phase 6b's rule on ``parity_runs``' steps: the step ``got`` against
    the step ``ref`` (the logs, every gradient and the updated parameters),
    each held to what four one-ulp nudges of the plain step move. The
    output is clamped to [0, 1] and, at random weights, mostly near 0, so
    a pixel whose pre-clamp value two forwards (≤ 5.2e-7 apart) put on two
    sides of 0 passes its gradient in one and not in the other; ReLUs do
    the same inside, and the small SEAN gradients (sums that cancel) move
    most. Each tensor's norm-relative difference may be ``GRAD_NOISE``×
    the largest change the nudges make in it, + ``GRAD_FLOOR``; all
    gradients together (as one vector) the larger of ``GRAD_NREL_ALL`` and
    ``GRAD_NOISE``× the nudges' change of that vector; the updated
    parameters ``GRAD_NOISE``× the largest nudge's change (both as the
    norm of the difference over the norm of the plain step's move). The
    conv biases before an InstanceNorm (a zero true gradient) may hold, on
    both sides, the larger of ``ZERO_GRAD_FLOOR`` and ``GRAD_NOISE``× what
    the plain step and its nudges hold, of the largest gradient. Returns
    (readings, the failed clauses)."""
    k_, r_, p_ = runs[got], runs[ref], runs["plain"]
    nudged = {lab: r for lab, r in runs.items() if "ulp" in lab}
    fails = []
    if any(not torch.equal(k_["start"][k], r_["start"][k]) for k in k_["start"]):
        fails.append("the two models did not start from the same weights")
    worst_log = max(abs(k_["logs"][k] - v) / max(abs(v), 1e-12)
                    for k, v in r_["logs"].items())
    if sorted(k_["logs"]) != sorted(r_["logs"]) or not worst_log <= 1e-5:
        fails.append(f"logs differ: {worst_log:.3g} relative")
    flips = int((k_["clamped"] ^ r_["clamped"]).sum())
    flips_n = {lab: int((r["clamped"] ^ p_["clamped"]).sum())
               for lab, r in nudged.items()}
    gp = r_["grads"]
    top = max(float(g.abs().max()) for g in gp.values())
    zero = [k for k in gp if _before_instance_norm(k)]

    def zero_share(run):
        return max((float(run["grads"][k].abs().max()) for k in zero),
                   default=0.0) / top

    zero_plain = max(zero_share(r) for r in (p_, *nudged.values()))
    zero_tol = max(ZERO_GRAD_FLOOR, GRAD_NOISE * zero_plain)
    zero_got = max(zero_share(k_), zero_share(r_))
    if not zero_got <= zero_tol:
        fails.append(f"zero-gradient biases: |g| {zero_got:.3g} of the "
                     f"largest > {zero_tol:.3g}")
    rows, num, den = [], 0.0, 0.0
    num_n = dict.fromkeys(nudged, 0.0)
    den_p = 0.0
    for k, refg in gp.items():
        if k in zero:
            continue
        d = k_["grads"][k] - refg
        num += float(d.square().sum())
        den += float(refg.square().sum())
        den_p += float(p_["grads"][k].square().sum())
        for lab, r in nudged.items():
            num_n[lab] += float((r["grads"][k] - p_["grads"][k]).square().sum())
        norm = float(refg.norm().clamp_min(1e-30))
        err = float(d.norm()) / norm
        pnorm = float(p_["grads"][k].norm().clamp_min(1e-30))
        noise = max(float((r["grads"][k] - p_["grads"][k]).norm()) / pnorm
                    for r in nudged.values())
        tol = GRAD_NOISE * noise + GRAD_FLOOR
        rows.append((err / tol, err, noise, k))
        if not err <= tol:
            fails.append(f"{k}: gradient norm-relative {err:.3g} > "
                         f"{GRAD_NOISE}× its one-ulp change {noise:.3g} + "
                         f"{GRAD_FLOOR:g}")
    rows.sort(reverse=True)
    nrel_all = (num / den) ** 0.5
    noise_all = max(v / den_p for v in num_n.values()) ** 0.5
    tol_all = max(GRAD_NREL_ALL, GRAD_NOISE * noise_all)
    if not nrel_all <= tol_all:
        fails.append(f"all gradients: norm-relative {nrel_all:.3g} > "
                     f"{tol_all:.3g}")

    def apart(a, b):
        num = sum(float((a["params"][k] - b["params"][k]).square().sum())
                  for k in gp)
        den = sum(float((b["params"][k] - b["start"][k]).square().sum())
                  for k in gp)
        return (num / den) ** 0.5

    prel = apart(k_, r_)
    prel_n = max(apart(r, p_) for r in nudged.values())
    if not prel <= GRAD_NOISE * prel_n:
        fails.append(f"updated parameters {prel:.3g} of the move apart, > "
                     f"{GRAD_NOISE}× the largest one-ulp change {prel_n:.3g}")
    log(f"[{label}] fp32 batch {k_['clamped'].shape[0]} full width: "
        f"logs ≤ {worst_log:.3g} relative (tol 1e-5); output pixels clamped "
        f"in one and not the other: {flips} (plain vs plain nudged: "
        + ", ".join(f"{lab} {n}" for lab, n in flips_n.items())
        + f"); zero-gradient biases ≤ {zero_got:.3g} of the largest gradient "
        f"(tol {zero_tol:.3g}; plain and nudged {zero_plain:.3g}); "
        f"gradients: all norm-relative {nrel_all:.3g} (tol {tol_all:.3g}; "
        f"the largest one-ulp change of all {noise_all:.3g}); per tensor "
        f"(norm-relative, tol {GRAD_NOISE}× its largest one-ulp change + "
        f"{GRAD_FLOOR:g}), nearest the bound: "
        + ", ".join(f"{k} {e:.3g} (one-ulp {n:.3g}, {q:.2f} of tol)"
                    for q, e, n, k in rows[:8])
        + f" ({len(rows)} tensors, largest difference "
        f"{max(r[1] for r in rows):.3g}); updated parameters {prel:.3g} of "
        f"the move apart (largest one-ulp change {prel_n:.3g})")
    return {"grad_nrel": nrel_all, "grad_nrel_noise": noise_all,
            "grad_nrel_tol": tol_all, "grad_nrel_worst": max(r[1] for r in rows),
            "grad_worst_of_tol": rows[0][0], "params_rel": prel,
            "logs_rel": worst_log, "clamp_flips": flips,
            "zero_grad": zero_got, "zero_grad_plain": zero_plain,
            "zero_grad_tol": zero_tol}, fails


def train_parity(torch, runs=None, label="train parity: default vs preset: "
                 "plain", ref="plain", got="kernels"):
    """Phase 6b: the default configuration's fp32 step against ``preset:
    plain``'s (``parity_runs``; or, given ``runs``, the step ``got``
    against the step ``ref``) by :func:`parity_readings`' rule; raises if
    a clause fails. Returns the readings."""
    runs = parity_runs(torch) if runs is None else runs
    readings, fails = parity_readings(torch, runs, label, ref, got)
    if fails:
        raise AssertionError(f"[{label}] " + "; ".join(fails))
    return readings


def grad_cases(torch, dt, gen):
    """The nine kernels with a gradient at the shapes the full-width ×8
    forwards give them (``make_cases``' main shapes): (name, the wrapper
    on leaf tensors, its plain version on them, the leaves). An HWNC
    operand is a view of a BHWC leaf, as in the forwards."""
    from endosr_torch.kernels.fused_mod import (fused_modulation,
                                                fused_modulation_plain)
    from endosr_torch.kernels.fused_obranch import (fused_o_branch,
                                                    fused_o_branch_plain)
    from endosr_torch.kernels.fused_tail import fused_tail, fused_tail_plain
    from endosr_torch.kernels.head_dot import head_dot, head_dot_plain
    from endosr_torch.kernels.output_stage import (output_stage,
                                                   output_stage_plain,
                                                   output_stage_x8,
                                                   output_stage_x8_plain)
    from endosr_torch.kernels.packed_chain import packed_g123, packed_g123_plain
    from endosr_torch.kernels.style_dot import (style_blend_dot,
                                                style_blend_plain,
                                                style_dot_hwbm, style_dot_plain)

    def rn(*shape, s=1.0, mean=0.0, dtype=dt):
        return (torch.randn(shape, generator=gen, device="cuda") * s
                + mean).to(dtype)

    def hwnc(t):
        return t.permute(1, 2, 0, 3)

    B = 8
    cases = []
    for label, xshape, cin4, phases in (("up1", (B, 128, 128, 256), 256, False),
                                        ("tail", (B, 129, 129, 512), 128, True)):
        leaves = [rn(*xshape, s=0.5), rn(2, 2, cin4, 128, s=0.03), rn(128, s=0.1),
                  rn(2, 2, 128, 128, s=0.04), rn(128, s=0.1),
                  rn(2, 2, 128, 128, s=0.04), rn(128, s=0.1)]
        if phases:
            leaves.append(rn(cin4, s=0.1))
        cases.append((
            f"packed_g123[{label}]",
            lambda x, *a, f=packed_g123, ph=phases: f(
                hwnc(x), *a[:6], True, a[6] if ph else None, ph),
            lambda x, *a, f=packed_g123_plain, ph=phases: f(
                hwnc(x), *a[:6], True, a[6] if ph else None, ph),
            leaves))
    m = 7 * 2 * 128
    blend = [(torch.rand((B, 128, 128, 90), generator=gen, device="cuda")
              > 0.8).to(dt), rn(B, 90, m, s=0.05),
             *[rn(B, 128, 128, 128, s=0.3) for _ in range(14)], rn(m, s=0.1)]
    cases.append((
        "style_blend_dot[M=1792]",
        lambda s, v, *r: style_blend_dot(s, v, tuple(map(hwnc, r[:-1])), r[-1]),
        lambda s, v, *r: style_blend_plain(s, v, tuple(map(hwnc, r[:-1])),
                                           r[-1]),
        blend))
    cases.append(("style_dot_hwbm[M=1792]", style_dot_hwbm, style_dot_plain,
                  blend[:2]))
    head = [rn(B, 257, 257, 512, s=0.5), rn(3, 3, 512, 64, s=0.02),
            rn(64, s=0.1, dtype=torch.float32), rn(512, s=0.1)]
    cases.append((
        "head_dot",
        lambda g4, w, b, pb: head_dot(hwnc(g4), w, b, 256, pb),
        lambda g4, w, b, pb: head_dot_plain(hwnc(g4), w, b, 256, pb), head))
    pre64 = rn(256, B, 256, 64, s=0.6, mean=0.5)
    cases.append((
        "output_stage_x8[x8 hbwc]",
        lambda p: output_stage_x8(p, 0.0, 1.0, "hbwc"),
        lambda p: output_stage_x8_plain(p, 0.0, 1.0, "hbwc"), [pre64]))
    cases.append((
        "output_stage[x8 r=4]", lambda p: output_stage(p, 4, 0.0, 1.0),
        lambda p: output_stage_plain(p, 4, 0.0, 1.0),
        [rn(B, 256, 256, 48, s=0.6, mean=0.5)]))
    d = torch.rand((B, 128, 128, 1), generator=gen, device="cuda").to(dt)
    o = [d, rn(26, 9, 128, s=0.3), rn(26, 128, s=0.1),
         rn(26, 9, 128, 128, s=1.0 / math.sqrt(9 * 128)), rn(26, 128, s=0.1)]
    cases.append(("fused_o_branch", fused_o_branch, fused_o_branch_plain, o))
    mask = (torch.rand((B, 128, 128, 10), generator=gen, device="cuda")
            > 0.8).to(dt)
    cases.append((
        "fused_modulation", fused_modulation, fused_modulation_plain,
        [d, mask, o[1], o[2], o[3].reshape(26, 9 * 128, 128),
         rn(B, 26, 90, 128, s=0.05), o[4]]))
    tail = [rn(B, 257, 257, 512, s=0.5), rn(3, 3, 512, 48, s=0.01),
            rn(48, s=0.1, mean=0.5, dtype=torch.float32), rn(512, s=0.1)]
    cases.append((
        "fused_tail",
        lambda g4, w, b, pb: fused_tail(hwnc(g4), w, b, 0.0, 1.0, "hwbc", 256,
                                        pb),
        lambda g4, w, b, pb: fused_tail_plain(hwnc(g4), w, b, 0.0, 1.0, "hwbc",
                                              256, pb), tail))
    return cases


def kernel_gradients(torch, counters):
    """Phase 6c: each of the nine kernels with a gradient, bf16 and fp32,
    at the full-width shapes: the gradient of every input through the
    wrapper (the kernel's forward, ``*_vjp`` backward) against autograd
    of its plain version, max |Δ| / max |ref| ≤ ``GRAD_TOL``; and the two
    kernels without one raise under autograd. Returns {kernel: {dtype:
    worst relative error}}."""
    from endosr_torch.kernels.fused_in_mod import fused_in_mod
    from endosr_torch.kernels.in_stats import in_stats

    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(5)
        tol = GRAD_TOL[str(dt)[6:]]
        for name, call, plain, inputs in grad_cases(torch, dt, gen):
            kernel = name.split("[")[0]
            counter = next(c for c in counters if c.__name__ == kernel)
            before = counter.launches

            def grads(fn):
                leaves = [t.detach().clone().requires_grad_(True)
                          for t in inputs]
                out = fn(*leaves)
                g = torch.randn(out.shape, generator=torch.Generator(
                    device="cuda").manual_seed(6), device="cuda").to(out.dtype)
                got = torch.autograd.grad(out, leaves, g, allow_unused=True)
                return [torch.zeros_like(t) if a is None else a
                        for a, t in zip(got, inputs)]

            got = grads(call)
            torch.cuda.synchronize()
            if counter.launches != before + 1:
                raise AssertionError(f"{name} {dt}: the wrapper launched "
                                     f"{counter.launches - before} kernels")
            want = grads(plain)
            errs = [rel_err(a, b)[1] for a, b in zip(got, want)]
            del got, want
            log(f"{name} gradient {str(dt)[6:]}: max |Δ| / max |ref| per "
                "input " + ", ".join(f"{e:.2e}" for e in errs)
                + f" (tol {tol:g})")
            if not max(errs) <= tol:
                raise AssertionError(f"{name} gradient {dt}: {max(errs)} > {tol}")
            row = worst.setdefault(kernel, {})
            row[str(dt)[6:]] = max(row.get(str(dt)[6:], 0.0), max(errs))
        torch.cuda.empty_cache()
    x = torch.rand((2, 16, 16, 64), device="cuda", requires_grad=True)
    for name, fn, field in (("in_stats", lambda: in_stats(x), "in_stats"),
                            ("fused_in_mod", lambda: fused_in_mod(x, x, x),
                             "fused_epilogue")):
        try:
            fn()
        except NotImplementedError as e:
            if field not in str(e):
                raise AssertionError(f"{name}: refused without naming "
                                     f"{field}: {e}") from e
            log(f"{name} under autograd on CUDA: NotImplementedError ({e})")
        else:
            raise AssertionError(f"{name} ran under autograd on CUDA")
    return worst


ENTRY_ROOT = "build/entry"      # under the repository root, git-ignored
ENTRY_TRAIN_ROUTES = {"packed_g123": "fp32", "style_blend_dot": "cuda_core",
                      "head_dot": "fp32", "output_stage_x8": "vec16"}
ENTRY_SERVE_WANT = {"style_dot_hwbm": 2, "output_stage": 1}
ENTRY_VAL_ROUTES = {"style_dot_hwbm": "cuda_core", "output_stage": "vec16"}
ENTRY_EVAL_ROUTES = {"style_dot_hwbm": "tc", "output_stage": "vec16"}
RESUME_REL = 1e-4       # resumed losses against the replay's (cuDNN's
                        # backward is not bit-stable on the card)
EXP = "experiments/DepthNet_ResBlk_depthMask_x8"
ENTRY_LR = {"train": (128, 128), "test": (120, 112)}   # ×8: GT 1024², 960×896
ENTRY_N = {"train": 16, "test": 2}


def _smooth_u8(np, rng, h, w):
    """Smooth random uint8 RGB [h, w, 3]: products of low-frequency sines
    and a little noise."""
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    chans = []
    for _ in range(3):
        f = rng.uniform(0.004, 0.03, 4).astype(np.float32)
        p = rng.uniform(0, 6.3, 2).astype(np.float32)
        chans.append(np.sin(xx * f[0] + p[0]) * np.cos(yy * f[1]) * 60
                     + np.sin(yy * f[2] + p[1]) * np.cos(xx * f[3]) * 50 + 128)
    img = np.stack(chans, -1) + rng.integers(0, 8, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _bicubic(np, img, scale):
    """``imresize_np(img, scale)`` of the port (MATLAB bicubic) as two
    BLAS matrix products with the same resample matrices: its einsums take
    seconds on a 1024² image; the sums run in another order."""
    from endosr_torch.ops.resize import resize_matrix

    h, w = img.shape[:2]
    m_h = resize_matrix(h, math.ceil(h * scale), scale, True)
    m_w = resize_matrix(w, math.ceil(w * scale), scale, True)
    x = np.ascontiguousarray(img.astype(np.float32).transpose(2, 0, 1))
    return np.ascontiguousarray((m_h @ x @ m_w.T).transpose(1, 2, 0))


def write_kvasir(root, scale=8, lr_hw=None, n=None):
    """Phase 7's synthetic Kvasir-style tree, written with ``cv2`` (which
    picks each row's PNG filter, as it does for a real dataset): 16 train pairs (GT 1024², LR 128², the MATLAB bicubic, ``_bicubic``)
    and 2 test pairs (GT 960×896, LR 120×112, so that bucketing pads),
    each with ``<stem>_disp.npy`` [1, 1, h, w]. ``scale``, ``lr_hw`` and
    ``n`` ({split: LR size / pairs}) give another tree (phase 9a)."""
    import numpy as np

    import cv2

    rng = np.random.default_rng(7)
    for split, (lh, lw) in (lr_hw or ENTRY_LR).items():
        for sub in ("HR", "LR", "depth"):
            (root / sub / split).mkdir(parents=True)
        for i in range((n or ENTRY_N)[split]):
            gt = _smooth_u8(np, rng, lh * scale, lw * scale)
            lr = _bicubic(np, gt.astype(np.float32) / 255.0, 1 / scale)
            lr = np.clip(lr * 255.0, 0, 255).round().astype(np.uint8)
            cv2.imwrite(str(root / "HR" / split / f"f{i:02d}.png"), gt)
            cv2.imwrite(str(root / "LR" / split / f"f{i:02d}.png"), lr)
            np.save(root / "depth" / split / f"f{i:02d}_disp.npy",
                    rng.random((1, 1, lh, lw), dtype=np.float32))


def _derive(src, dst, changes, tag="entry"):
    """Write ``src`` (a YAML of the repo) with ``changes`` ({dotted key:
    value}) as ``dst``, logging each change as a ``reduced`` line."""
    import yaml

    y = yaml.safe_load(src.read_text())
    for key, value in changes.items():
        *parents, leaf = key.split(".")
        node = y
        for p in parents:
            node = node[p]
        log(f"[{tag}] reduced: {src.name} {key}: {node.get(leaf)!r} → "
            f"{value!r}")
        node[leaf] = value
    dst.write_text(yaml.safe_dump(y))
    return str(dst)


def _host_tree(x):
    """``x`` (nested dicts, lists and tensors) with every tensor copied to
    the host."""
    if hasattr(x, "detach"):
        return x.detach().cpu().clone()
    if isinstance(x, dict):
        return {k: _host_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host_tree(v) for v in x)
    return x


def _tree_equal(torch, a, b):
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(torch, a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tree_equal(torch, x, y)
                                        for x, y in zip(a, b))
    return a == b


class EntryTaps:
    """Wraps ``FModelDepthCond.optimize_parameters``, ``test`` and
    ``resume_training`` for phase 7: every call runs with the launch counts
    set to 0 just before it and read just after it (synchronised, host
    clock), recorded under ``self.training`` or ``self.serving``."""

    def __init__(self, torch, counters):
        self.torch, self.counters = torch, counters
        self.training, self.serving = "train entry", None
        self.calls: dict[str, list] = {}
        self.step2 = self.resumed = None

    def _state(self, model):
        return _host_tree({"optimizer": model.optimizer_G.state_dict(),
                           "netG": model.netG.state_dict(),
                           "dyn": model.dyn_weight, "step": model.step})

    def _call(self, label, model, fn, args, kwargs, training=False):
        torch = self.torch
        torch.cuda.synchronize()
        zero_counts(self.counters)
        t = time.perf_counter()
        out = fn(model, *args, **kwargs)
        torch.cuda.synchronize()
        rec = {"secs": time.perf_counter() - t,
               "launches": {c.__name__: c.launches for c in self.counters},
               "routes": {c.__name__: dict(c.routes) for c in self.counters
                          if hasattr(c, "routes")}}
        if training:
            rec["logs"] = dict(model.log_dict)
            if model.step == 2 and self.step2 is None:
                self.step2 = self._state(model)
        else:
            rec["sr"] = out.detach().float().cpu()
        self.calls.setdefault(label, []).append(rec)
        return out

    def install(self):
        from endosr_torch.models.f_depthcond import FModelDepthCond as M

        saved = (M.optimize_parameters, M.test, M.resume_training)
        opt, test, resume = saved

        def optimize_parameters(model, *a, **k):
            return self._call(self.training, model, opt, a, k, True)

        def test_(model, *a, **k):
            return self._call(self.serving, model, test, a, k)

        def resume_training(model, path):
            out = resume(model, path)
            if self.resumed is None:
                self.resumed = self._state(model)
            return out

        M.optimize_parameters, M.test, M.resume_training = (
            optimize_parameters, test_, resume_training)

        def uninstall():
            M.optimize_parameters, M.test, M.resume_training = saved

        return uninstall

    def check(self, label, calls, want, routes):
        check_launches(label, calls, want, routes)


def check_launches(label, calls, want, routes):
    """Each record of ``calls`` launched ``want`` (every other counter 0),
    all on ``routes``."""
    for n, rec in enumerate(calls):
        for name, got in rec["launches"].items():
            if got != want.get(name, 0):
                raise AssertionError(f"[{label}] call {n + 1}: {name} {got} "
                                     f"launches, want {want.get(name, 0)}")
        for name, route in routes.items():
            took = {**dict.fromkeys(rec["routes"][name], 0),
                    route: rec["launches"][name]}
            if rec["routes"][name] != took:
                raise AssertionError(f"[{label}] call {n + 1}: {name} routes "
                                     f"{rec['routes'][name]}, want {took}")


def _loader_rate(yaml_path):
    """The training loader of ``yaml_path``: images/s of its first epoch,
    and of that the seconds to start it (this process fills the cache:
    decode, bins; then the workers fork), then, on the filled cache, an epoch of 8× the index space
    (``dataset_enlarge_ratio: 8``): the seconds to its first batch (the
    workers start) and the images/s of the batches after it; last, with
    ``cache_data`` off (the workers decode and prepare every image), the
    images/s of such an epoch, the workers' start included."""
    from endosr_torch.config import options as option
    from endosr_torch.data import create_dataloader, create_dataset

    opt = option.dict_to_nonedict(option.parse(yaml_path, is_train=True))
    ds_opt = opt["datasets"]["train"]
    ds = create_dataset(ds_opt)
    t = time.perf_counter()
    it = iter(create_dataloader(ds, ds_opt, opt, pin_memory=True))
    fill_s = time.perf_counter() - t
    n = sum(b["LQ"].shape[0] for b in it)
    epoch0 = n / (time.perf_counter() - t)
    loader = create_dataloader(ds, {**ds_opt, "dataset_enlarge_ratio": 8},
                               opt, pin_memory=True)
    loader.set_epoch(1)
    t = time.perf_counter()
    it = iter(loader)
    next(it)
    t1 = time.perf_counter()
    n = sum(b["LQ"].shape[0] for b in it)
    steady = n / (time.perf_counter() - t1)
    first_batch_s = t1 - t
    plain_opt = {**ds_opt, "cache_data": False, "dataset_enlarge_ratio": 8}
    loader = create_dataloader(create_dataset(plain_opt), plain_opt, opt,
                               pin_memory=True)
    loader.set_epoch(1)
    t = time.perf_counter()
    m = sum(b["LQ"].shape[0] for b in loader)
    return {"epoch0": epoch0, "fill_s": fill_s,
            "first_batch_s": first_batch_s,
            "steady": steady, "steady_images": n,
            "no_cache": m / (time.perf_counter() - t)}


def _psnr_unclamped(a, b):
    """(PSNR of ``a`` against ``b`` over the values that neither clamps to
    0 or 1, their share)."""
    import numpy as np

    keep = (a > 0) & (a < 1) & (b > 0) & (b < 1)
    d = a[keep].astype(np.float64) - b[keep]
    mse = float(np.mean(d ** 2)) if d.size else float("nan")
    db = 10 * math.log10(1.0 / mse) if mse > 0 else float("inf")
    return db, float(keep.mean())


def _replay_resume(yaml_path, state_path, steps):
    """The resume rule through the model API: ``state_path`` restored, then
    the first ``steps`` batches of its saved epoch."""
    from endosr_torch.config import options as option
    from endosr_torch.data import create_dataloader, create_dataset
    from endosr_torch.models import create_model
    from endosr_torch.utils import misc as util

    opt = option.dict_to_nonedict(option.parse(yaml_path, is_train=True))
    util.set_random_seed(opt["train"]["manual_seed"])
    model = create_model(opt)
    epoch, step = model.resume_training(str(state_path))
    ds_opt = opt["datasets"]["train"]
    loader = create_dataloader(create_dataset(ds_opt), ds_opt, opt,
                               pin_memory=True)
    loader.set_epoch(epoch)
    for n, batch in enumerate(loader, 1):
        model.feed_data(batch)
        model.optimize_parameters(step + n)
        if n == steps:
            break


def _centred_weights(torch, test_yaml, src, dst):
    """``src`` with its output conv scaled by s ≤ 1 and shifted, per
    colour, so that the fp32 output of the test set (its clamp opened) has
    its median at 0.5 and its 1st and 99th percentiles within [0.1, 0.9];
    written to ``dst``. Returns (s, the shifts)."""
    import numpy as np

    from endosr_torch.config import options as option
    from endosr_torch.data import create_dataloader, create_dataset
    from endosr_torch.models import create_model

    opt = option.dict_to_nonedict(option.parse(test_yaml, is_train=False))
    opt["precision"] = "fp32"
    opt["path"]["pretrain_model_G"] = str(src)
    model = create_model(opt)
    model.netG.clamp_min, model.netG.clamp_max = -1e4, 1e4
    ds_opt = opt["datasets"]["test_1"]
    outs = []
    for batch in create_dataloader(create_dataset(ds_opt), ds_opt):
        model.feed_data(batch)
        model.test()
        outs.append(model.fake_SR.float().reshape(-1, 3).cpu().numpy())
    del model
    lo, med, hi = np.percentile(np.concatenate(outs), [1, 50, 99], axis=0)
    half = float(np.max(np.maximum(med - lo, hi - med)))
    scale = min(1.0, 0.4 / half) if half > 0 else 1.0
    sd = torch.load(str(src), map_location="cpu", weights_only=True)
    shift = torch.as_tensor(0.5 - scale * med, dtype=sd["conv_output.bias"].dtype)
    sd["conv_output.weight"] = sd["conv_output.weight"] * scale
    sd["conv_output.bias"] = sd["conv_output.bias"] * scale + shift
    torch.save(sd, str(dst))
    return scale, shift.tolist()


def entry_points(torch, counters):
    """Phase 7: ``python -m endosr_torch.train`` and ``.test`` as a user
    runs them (through ``main``), on a synthetic Kvasir tree at full size,
    from the repo's own ×8 training YAML and test YAML. Returns
    ({path label: launches}, the readings)."""
    import shutil
    from pathlib import Path

    import cv2

    import endosr_torch.test as entry_test
    import endosr_torch.train as entry_train
    from endosr_torch.config import options as option
    from endosr_torch.data import create_dataloader, create_dataset
    from endosr_torch.models import create_model

    def imread(path):
        return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)

    repo = Path(__file__).resolve().parent
    root = repo / ENTRY_ROOT
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_kvasir(root / "data")
    log(f"[entry] synthetic Kvasir tree ({ENTRY_N['train']} train pairs at "
        f"LR {ENTRY_LR['train']}, {ENTRY_N['test']} test pairs at LR "
        f"{ENTRY_LR['test']}, ×8) written in {time.perf_counter() - t0:.1f} s")

    def roots(split):
        return {"dataroot_GT": str(root / "data/HR" / split),
                "dataroot_LQ": str(root / "data/LR" / split),
                "dataroot_depthMap": str(root / "data/depth" / split)}

    train_changes = {
        **{f"datasets.train.{k}": v for k, v in roots("train").items()},
        **{f"datasets.val.{k}": v for k, v in roots("test").items()},
        "datasets.train.data_num": 16, "path.root": str(root / "run"),
        "train.niter": 4, "train.val_freq": 4,
        "logger.save_checkpoint_freq": 2, "logger.print_freq": 1}
    src = repo / "options/train/train_depthNet_SEAN_depthMask_x8.yml"
    train_yaml = _derive(src, root / "train.yml", train_changes)
    resume_yaml = _derive(root / "train.yml", root / "resume.yml", {
        "path.root": str(root / "resumed"), "path.resume_state": "auto"})
    latest = root / "run" / EXP / "models/latest_G.pth"
    centred = root / "eval_G.pth"       # latest_G.pth, output conv centred
    test_yaml = _derive(repo / "options/test/test_depthNet.yml",
                        root / "test.yml", {
                            **{f"datasets.test_1.{k}": v
                               for k, v in roots("test").items()},
                            "path.root": str(root / "eval"),
                            "path.pretrain_model_G": str(centred)})

    rates = _loader_rate(train_yaml)
    log(f"[entry] training loader (batch 8, 4 workers, cache_data, "
        f"u8_pipeline, flips and rotations, pinned): {rates['epoch0']:.1f} "
        f"images/s in epoch 0, {rates['fill_s']:.2f} s of it to fill the "
        f"cache and start the workers; on the cache, "
        f"{rates['first_batch_s']:.2f} s to the first batch (workers "
        f"start), then {rates['steady']:.1f} images/s over "
        f"{rates['steady_images']} images; cache_data off: "
        f"{rates['no_cache']:.1f} images/s over 128 images (workers' start "
        f"included)")

    taps = EntryTaps(torch, counters)
    uninstall = taps.install()
    try:
        taps.serving = "val entry"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        entry_train.main(["-opt_F", train_yaml])
        train_secs = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() / 2**30
        first = list(taps.calls["train entry"])
        first_val = list(taps.calls["val entry"])

        # resume from step 2 (the end of epoch 0) in a copy of the run
        # without its step-4 files
        shutil.copytree(root / "run", root / "resumed", ignore=lambda d, names: [
            n for n in names if n.startswith(("4", "latest"))])
        entry_train.main(["-opt_F", resume_yaml])
        resumed = taps.calls["train entry"][len(first):]
        resumed_val = taps.calls["val entry"][len(first_val):]

        # the resume rule (the saved epoch again from its first batch)
        # through the model API, from the first run's 2.state
        taps.training = "train replay"
        _replay_resume(resume_yaml, root / "run" / EXP
                       / "training_state/2.state", len(resumed))
        replay = taps.calls["train replay"]

        taps.serving = "eval probe"
        scale, shift = _centred_weights(torch, test_yaml, latest, centred)
        log(f"[entry] eval weights: latest_G.pth with conv_output scaled by "
            f"{scale:.6g} and its bias shifted by {shift} (fp32 output "
            f"median 0.5, 1st-99th percentiles within [0.1, 0.9])")
        taps.serving = "eval entry"
        t = time.perf_counter()
        eval_model = entry_test.main(["-opt_F", test_yaml])
        eval_secs = time.perf_counter() - t
        evals = list(taps.calls["eval entry"])
        precision = eval_model.opt["precision"]
        del eval_model

        # the same weights served in fp32, for the bf16 PSNR
        taps.serving = "eval fp32"
        opt32 = option.dict_to_nonedict(option.parse(test_yaml, is_train=False))
        opt32["precision"] = "fp32"
        ds_opt = opt32["datasets"]["test_1"]
        m32 = create_model(opt32)
        for batch in create_dataloader(create_dataset(ds_opt), ds_opt):
            m32.feed_data(batch)
            m32.test()
        ref32 = [r["sr"] for r in taps.calls["eval fp32"]]
        del m32
    finally:
        uninstall()
    torch.cuda.empty_cache()

    # training: counts and routes a step, finite losses, files and logs
    taps.check("train entry", first + resumed, TRAIN_WANT, ENTRY_TRAIN_ROUTES)
    taps.check("val entry", first_val + resumed_val, ENTRY_SERVE_WANT,
               ENTRY_VAL_ROUTES)
    if (len(first), len(resumed), len(first_val), len(resumed_val)) != (4, 2, 2, 2):
        raise AssertionError(
            f"[entry] {len(first)} + {len(resumed)} steps and {len(first_val)}"
            f" + {len(resumed_val)} validation images, want 4 + 2 and 2 + 2")
    losses = [r["logs"]["l_all"] for r in first + resumed]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[entry] losses {losses}")
    exp = root / "run" / EXP
    for rel in ("models/2_G.pth", "models/4_G.pth", "models/latest_G.pth",
                "training_state/2.state", "training_state/4.state"):
        if not (exp / rel).is_file():
            raise AssertionError(f"[entry] {rel} was not written")
    test_hw = tuple(8 * x for x in ENTRY_LR["test"]) + (3,)
    for name in ("f00", "f01"):
        img = imread(exp / "val_images" / name / f"{name}_4.png")
        if img is None or img.shape != test_hw:
            raise AssertionError(f"[entry] val image {name}: {img.shape}")
    text = "".join(p.read_text() for p in exp.glob("train_*.log"))
    val_text = "".join(p.read_text() for p in exp.glob("val_*.log"))
    for want in ("iter:       1,", "iter:       4,", "# Validation # PSNR",
                 "Saving the final model."):
        if want not in text:
            raise AssertionError(f"[entry] the training log lacks {want!r}")
    if "iter:       4> psnr:" not in val_text:
        raise AssertionError("[entry] the validation log lacks step 4's line")

    # resume: step 2's state reloads bit-equal; steps 3-4 rerun epoch 0,
    # as the replay of that rule does
    if taps.step2 is None or taps.resumed is None or not _tree_equal(
            torch, taps.step2, taps.resumed):
        raise AssertionError("[entry] the state resumed from 2.state is not "
                             "step 2's (Adam state, weights, K-vector, step)")
    if len(replay) != len(resumed):
        raise AssertionError(f"[entry] the replay took {len(replay)} steps")
    worst = 0.0
    for a, b in zip(replay, resumed):
        for k in ("l_pix", "l_dynamic", "l_all"):
            worst = max(worst, abs(b["logs"][k] - a["logs"][k])
                        / abs(a["logs"][k]))
    rtext = "".join(p.read_text() for p in (root / "resumed" / EXP).glob(
        "train_*.log"))
    if ("Start training from epoch: 0, iter: 2" not in rtext
            or "<epoch:  0, iter:       3," not in rtext):
        raise AssertionError("[entry] the resumed run did not rerun epoch 0 "
                             "from step 3")
    log(f"[entry] resumed from 2.state: Adam state, weights and K-vector "
        f"bit-equal to step 2's; steps 3-4 rerun epoch 0, losses within "
        f"{worst:.3g} relative of the replay's (tol {RESUME_REL:g})")
    if not worst <= RESUME_REL:
        raise AssertionError(f"[entry] resumed losses {worst} apart")

    # evaluation: precision, counts, TSV, PNGs, PSNR against fp32
    if precision != "bf16":
        raise AssertionError(f"[entry] eval precision {precision}, want bf16")
    taps.check("eval entry", evals, ENTRY_SERVE_WANT, ENTRY_EVAL_ROUTES)
    res = root / "eval/results/DepthNet_test"
    rows = (res / "result_x8.tsv").read_text().splitlines()
    if (rows[0] != "Name\tPSNR\tSSIM\tPSNR_Y\tSSIM_Y"
            or [r.split("\t")[0] for r in rows[1:]] != ["f00", "f01", "Average"]
            or not all(math.isfinite(float(v)) for r in rows[1:]
                       for v in r.split("\t")[1:])):
        raise AssertionError(f"[entry] result_x8.tsv: {rows}")
    pngs = sorted((res / "x8").glob("*.png"))
    if [p.name for p in pngs] != ["f00.png", "f01.png"] or any(
            getattr(imread(p), "shape", None) != test_hw for p in pngs):
        raise AssertionError(f"[entry] eval PNGs {pngs}")
    dbs, shares = zip(*(_psnr_unclamped(e["sr"].numpy(), r.numpy())
                        for e, r in zip(evals, ref32)))
    if len(dbs) != 2 or not min(shares) >= 0.9 or not min(dbs) >= 40.0:
        raise AssertionError(f"[entry] eval bf16 vs fp32 PSNR {dbs} dB over "
                             f"the unclamped shares {shares} (min 40 dB, "
                             "0.9)")

    step_ms = sum(r["secs"] for r in first[1:]) / 3 * 1e3
    numbers = {
        "train_ms_per_step": step_ms, "train_peak_gib": peak,
        "train_main_s": train_secs,
        "loader": rates,
        "val_forward_ms": [r["secs"] * 1e3 for r in first_val],
        "eval_forward_ms": [r["secs"] * 1e3 for r in evals],
        "eval_main_s": eval_secs, "eval_psnr_vs_fp32_db": dbs,
        "eval_unclamped_share": shares, "eval_conv_output_scale": scale,
        "replay_losses": [r["logs"]["l_all"] for r in replay],
        "losses": losses, "resume_worst_rel": worst, "tsv": rows}
    log(f"[entry] train.main (×8 YAML, fp32, batch 8, GT 1024²): "
        f"{step_ms:.1f} ms a step (mean of steps 2-4, host clock, "
        f"synchronised), peak device memory {peak:.2f} GiB, "
        f"{train_secs:.1f} s in all; l_all {losses}; validation "
        + ", ".join(f"{x:.1f}" for x in numbers["val_forward_ms"])
        + " ms an image (forward); test.main (bf16): "
        + ", ".join(f"{x:.1f}" for x in numbers["eval_forward_ms"])
        + f" ms an image (forward), {eval_secs:.1f} s in all; bf16 vs fp32 "
        f"PSNR {', '.join(f'{d:.2f}' for d in dbs)} dB over the unclamped "
        f"{', '.join(f'{x:.4f}' for x in shares)} of the values; "
        f"{gpu_line()}")
    launches = {label: {c.__name__: sum(r["launches"][c.__name__]
                                        for r in taps.calls[label])
                        for c in counters}
                for label in ("train entry", "val entry", "eval entry")}
    return launches, numbers


X2_YAML = "options/train/train_depthNet_SEAN_depthMask_x2.yml"
X3_YAML = "options/train/train_depthNet_SEAN_depthMask_endoscene_x3.yml"
X2_LR = (512, 512)          # Kvasir ×2 (the ×2 YAML's): LQ 512² → SR 1024²
# mismatch-PSNR floors against fp32 on the same weights: the JAX package's
# (``tests/test_bf16_quality.py``; plain bf16 at ×2 is its 25 dB regime)
X2_FLOOR = {"bf16c3": 50.0, "bf16c": 40.0, "mixed": 45.0, "bf16": 25.0}
X2_PLAIN_TOL = 2e-4         # fp32 against fp32 plain: the repo's parity bar
X2_PLAIN_BATCH = 2          # images a plain reference forward holds
# launches a ×2 request makes: with bf16 maps in an fp32 net the style groups
# go where the JAX module sends them, and its blend kernel does not fit LQ
# 512² at batch 8 (``nn/depthnet.py::_jax_blend_fits``): ``style_dot_hwbm``
X2_WANT = {
    "fp32": ({"style_blend_dot": 2, "output_stage": 1},
             {"style_blend_dot": "cuda_core", "output_stage": "vec16"}),
    "bf16": ({"style_blend_dot": 2, "output_stage": 1},
             {"style_blend_dot": "tc", "output_stage": "vec16"}),
    **{p: ({"style_dot_hwbm": 2, "output_stage": 1},
           {"style_dot_hwbm": "tc", "output_stage": "vec16"})
       for p in ("mixed", "bf16c", "bf16c3")},
}
X3_ROOT = "build/endoscene"     # under the repository root, git-ignored
X3_GT = (574, 500)              # a CVC-EndoSceneStill frame
X3_N = 4
# an ×3 image: LQ 191×166 (of the modcropped 573×498 frame); its width is
# no multiple of 8, so the style groups take ``style_dot_hwbm``, and its
# rows of 166·27 values are no multiple of 16 bytes, so ``output_stage``
# takes route ``v1``
X3_WANT = {"style_dot_hwbm": 2, "output_stage": 1}
X3_ROUTES = {"style_dot_hwbm": "tc", "output_stage": "v1"}


def kernel_call_check(torch, gen, name, dt, route, shape, extra=(),
                      grad=False):
    """One call of the kernel ``name`` on the card at a path's shape and
    storage type ``dt``, against its plain version on the same inputs: it
    must take ``route``; its output is held image by image for the dots
    (fp32 against float64 ≤ 1e-5 of max |ref|, bf16 against the bf16 plain
    version ≤ 1e-2, as phase 3 holds them) and bit for bit for the output
    stages. With ``grad``, so is the gradient of every input through the
    wrapper (the kernel's forward, its ``*_vjp`` backward) against
    autograd of the plain version: a dot's per input, fp32 against
    float64 ≤ 1e-5 of max |ref|, bf16 ≤ ``GRAD_TOL``; an output stage's
    bit for bit. ``shape``: (B, H, W, J, M) of a dot, the input's of an
    output stage; ``extra``: a blend's conv width 2C; (r, clamp min, clamp
    max) of ``output_stage``; (order, clamp min, clamp max) of
    ``output_stage_x8``. ``packed_g123`` and ``head_dot`` are held whole
    (fp32 against float64 ≤ 1e-5 of max |ref|, bf16 against the bf16
    plain version ≤ 1e-2, as phase 3 holds them; the gradient of every
    input ≤ ``GRAD_TOL`` of its max |ref| against autograd of the plain
    version at the storage type, as phase 6c): ``shape`` is x's HWNC shape +
    (Cin4, C4) of ``packed_g123``, g4's + (Cout,) of ``head_dot``;
    ``extra`` (pre_act, phases, the weights' and biases' types) and (wout,
    those types), a pre-bias given when there is a type for it. Returns
    (readings, the failed clauses)."""
    from endosr_torch.kernels.head_dot import head_dot, head_dot_plain
    from endosr_torch.kernels.output_stage import (output_stage,
                                                   output_stage_plain,
                                                   output_stage_x8,
                                                   output_stage_x8_plain)
    from endosr_torch.kernels.packed_chain import packed_g123, packed_g123_plain
    from endosr_torch.kernels.style_dot import (style_blend_dot,
                                                style_blend_plain,
                                                style_dot_hwbm, style_dot_plain)

    def rn(*shape, s=1.0, mean=0.0, dtype=dt):
        return (torch.randn(shape, generator=gen, device="cuda") * s
                + mean).to(getattr(torch, dtype) if isinstance(dtype, str)
                           else dtype)

    def hwnc(t):
        return t.permute(1, 2, 0, 3)

    fails, batched, dense = [], 0, name in ("packed_g123", "head_dot")
    if name == "packed_g123":
        hx, wx, b, c, cin4, c4 = shape
        pre_act, phases, wdt = extra
        fn, pb = packed_g123, len(wdt) == 3
        leaves = [rn(b, hx, wx, c, s=0.5), rn(2, 2, cin4, c4, s=0.03,
                                              dtype=wdt[0]),
                  rn(c4, s=0.1, dtype=wdt[1]),
                  rn(2, 2, c4, c4, s=0.04, dtype=wdt[0]),
                  rn(c4, s=0.1, dtype=wdt[1]),
                  rn(2, 2, c4, c4, s=0.04, dtype=wdt[0]),
                  rn(c4, s=0.1, dtype=wdt[1])]
        if pb:
            leaves.append(rn(cin4, s=0.1, dtype=wdt[2]))

        def call(x, *a, f=packed_g123):
            return f(hwnc(x), *a[:6], pre_act, a[6] if pb else None, phases)

        plain = functools.partial(call, f=packed_g123_plain)
    elif name == "head_dot":
        hp, wc, b, c4, cout = shape
        wout, wdt = extra
        fn, pb = head_dot, len(wdt) == 3
        leaves = [rn(b, hp, wc, c4, s=0.5),
                  rn(3, 3, c4, cout, s=0.02, dtype=wdt[0]),
                  rn(cout, s=0.1, dtype=wdt[1])]
        if pb:
            leaves.append(rn(c4, s=0.1, dtype=wdt[2]))

        def call(g4, w, b_, *p, f=head_dot):
            return f(hwnc(g4), w, b_, wout, p[0] if pb else None)

        plain = functools.partial(call, f=head_dot_plain)
    elif name == "output_stage":
        r, lo, hi = extra
        fn, leaves = output_stage, [rn(*shape, s=0.6, mean=0.5)]
        call = functools.partial(output_stage, r=r, clamp_min=lo, clamp_max=hi)
        plain = functools.partial(output_stage_plain, r=r, clamp_min=lo,
                                  clamp_max=hi)
    elif name == "output_stage_x8":
        order, lo, hi = extra
        fn, leaves = output_stage_x8, [rn(*shape, s=0.6, mean=0.5)]
        call = functools.partial(output_stage_x8, clamp_min=lo, clamp_max=hi,
                                 order=order)
        plain = functools.partial(output_stage_x8_plain, clamp_min=lo,
                                  clamp_max=hi, order=order)
    else:
        b, h, w, j, m = shape
        leaves = [(torch.rand((b, h, w, j), generator=gen, device="cuda")
                   > 0.8).to(dt), rn(b, j, m, s=0.05)]
        fn, call, plain = style_dot_hwbm, style_dot_hwbm, style_dot_plain
        if name == "style_blend_dot":
            leaves += [rn(b, h, w, extra[0], s=0.3)
                       for _ in range(m // extra[0])]
            leaves.append(rn(m, s=0.1, dtype=torch.float32))
            fn = style_blend_dot

            def call(s, v, *r):
                return style_blend_dot(s, v, tuple(map(hwnc, r[:-1])), r[-1])

            def plain(s, v, *r):
                return style_blend_plain(s, v, tuple(map(hwnc, r[:-1])), r[-1])
        batched = len(leaves) - (name == "style_blend_dot")
    before = dict(fn.routes)
    got = call(*leaves)
    torch.cuda.synchronize()
    took = {k: n - before[k] for k, n in fn.routes.items()}
    if took != {**dict.fromkeys(took, 0), route: 1}:
        fails.append(f"routes {took}, want one launch on {route}")
    out = {}
    ref_dt = torch.float64 if dt == torch.float32 else dt
    if dense:
        want = plain(*(t.to(ref_dt) if t.dtype == dt else t for t in leaves))
        out["max_abs"], out["rel"] = rel_err(got, want)
        tol = 1e-5 if dt == torch.float32 else 1e-2
        if not out["rel"] <= tol:
            fails.append(f"rel err {out['rel']:.3g} > {tol:g}")
        del want
    elif not batched:
        want = plain(*leaves)
        out["max_abs"] = rel_err(got, want)[0]
        if not torch.equal(got, want):
            fails.append(f"not bit-identical (max |Δ| {out['max_abs']:.3g})")
    else:
        tol = 1e-5 if dt == torch.float32 else 1e-2
        per = []
        for k in range(shape[0]):
            one = [t[k:k + 1] if i < batched else t
                   for i, t in enumerate(leaves)]
            per.append(rel_err(got[:, :, k:k + 1],
                               plain(*(t.to(ref_dt) for t in one))))
        out["max_abs"] = max(e[0] for e in per)
        out["rel"] = max(e[1] for e in per)
        if not out["rel"] <= tol:
            fails.append(f"rel err {out['rel']:.3g} > {tol:g}")
    out_shape, out_dt = tuple(got.shape), got.dtype
    del got
    if grad:
        g = torch.randn(out_shape, generator=gen, device="cuda").to(out_dt)
        xs = [t.detach().requires_grad_(True) for t in leaves]
        gk = torch.autograd.grad(call(*xs), xs, g)
        del xs
        if dense:
            # the kernel's backward is the plain version's VJP, recomputed
            # at the storage type (as phase 6c holds it): against float64
            # the ReLUs' kinks would take other sides
            xs = [t.detach().requires_grad_(True) for t in leaves]
            gp = torch.autograd.grad(plain(*xs), xs, g)
            rels = [rel_err(a, b_)[1] for a, b_ in zip(gk, gp)]
            out["grad_rel"], out["grad_rel_per_input"] = max(rels), rels
            tol = GRAD_TOL[str(dt)[6:]]
            if not out["grad_rel"] <= tol:
                fails.append("gradient max |Δ| / max |ref| per input "
                             + ", ".join(f"{e:.3g}" for e in rels)
                             + f" > {tol:g}")
            del gp
        elif not batched:
            xs = [t.detach().requires_grad_(True) for t in leaves]
            gp = torch.autograd.grad(plain(*xs), xs, g)
            out["grad_rel"] = max(rel_err(a, b_)[1] for a, b_ in zip(gk, gp))
            if not all(torch.equal(a, b_) for a, b_ in zip(gk, gp)):
                fails.append(f"gradient not bit-identical (max |Δ| / max "
                             f"|ref| {out['grad_rel']:.3g})")
        else:
            tol = 1e-5 if dt == torch.float32 else GRAD_TOL["bfloat16"]
            num, den = [0.0] * len(leaves), [0.0] * len(leaves)
            acc = [None] * len(leaves)
            for k in range(shape[0]):
                xk = [(t[k:k + 1] if i < batched else t).detach().to(ref_dt)
                      .requires_grad_(True) for i, t in enumerate(leaves)]
                gr = torch.autograd.grad(plain(*xk), xk,
                                         g[:, :, k:k + 1].to(ref_dt))
                for i, a in enumerate(gr):
                    if i < batched:
                        d = (gk[i][k:k + 1].to(ref_dt) - a).abs().max()
                        num[i] = max(num[i], float(d))
                        den[i] = max(den[i], float(a.abs().max()))
                    else:
                        acc[i] = a if acc[i] is None else acc[i] + a
            for i in range(batched, len(leaves)):
                num[i] = float((gk[i].to(ref_dt) - acc[i]).abs().max())
                den[i] = float(acc[i].abs().max())
            rels = [n / max(d, 1e-30) for n, d in zip(num, den)]
            out["grad_rel"] = max(rels)
            out["grad_rel_per_input"] = rels
            if not out["grad_rel"] <= tol:
                fails.append("gradient max |Δ| / max |ref| per input "
                             + ", ".join(f"{e:.3g}" for e in rels)
                             + f" > {tol:g}")
        del gk
    return out, fails


# the kernel calls of phase 8's paths: (kernel, storage type, route,
# (B, H, W, M) of a dot or (B, H, W, r) of an output stage): the ×2
# requests (batch 8, LQ 512²; style groups of 7 and 6 blocks, M = 1792 /
# 1536: mixed, bf16c and bf16c3 dot them, fp32 and bf16 blend them; the
# tail's r = 2 stage in fp32, and in bf16 at bf16) and the ×3 frame (LQ
# 191×166; bf16c3 dots both groups; the r = 3 stage in fp32)
X23_CALLS = (
    *(("style_dot_hwbm", "bfloat16", "tc", (8, 512, 512, m)) for m in (1792, 1536)),
    *(("style_blend_dot", dt, route, (8, 512, 512, m)) for m in (1792, 1536)
      for dt, route in (("float32", "cuda_core"), ("bfloat16", "tc"))),
    *(("output_stage", dt, "vec16", (8, 512, 512, 2)) for dt in ("float32", "bfloat16")),
    *(("style_dot_hwbm", "bfloat16", "tc", (1, 191, 166, m)) for m in (1792, 1536)),
    ("output_stage", "float32", "v1", (1, 191, 166, 3)),
)


def path_kernel_checks(torch):
    """Phase 8a: every kernel call of ``X23_CALLS`` on the card at its
    path's shape and type, by :func:`kernel_call_check` (a style group's
    J = 90 shifted mask channels, its convs 2C = 128 wide; clamp [0, 1]).
    Returns {kernel: {type: max |Δ|}}."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    errs = {}
    for name, dts, route, (b, h, w, m) in X23_CALLS:
        if name == "output_stage":
            shape, extra = (b, h, w, 3 * m * m), (m, 0.0, 1.0)
            what = f"[{b},{h},{w},{3 * m * m}] r={m}"
        else:
            shape, extra = (b, h, w, 90, m), (128,)
            what = f"[{b},{h},{w},90]×[{b},90,{m}]"
        out, fails = kernel_call_check(torch, gen, name, getattr(torch, dts),
                                       route, shape, extra)
        torch.cuda.empty_cache()
        if fails:
            raise AssertionError(f"[x2/x3] {name} {dts} {what}: "
                                 + "; ".join(fails))
        log(f"[x2/x3] {name} {dts} {what}: route {route}, max|Δ| "
            f"{out['max_abs']:.3e} "
            + ("(bit-identical)" if "rel" not in out else
               f"rel {out['rel']:.3e} against the plain version (image by "
               "image)"))
        slot = errs.setdefault(name, {})
        slot[dts] = max(slot.get(dts, 0.0), out["max_abs"])
    return errs


def centered_conv_times(torch):
    """Phase 8b: ``centered_conv`` on one trunk conv ([8, 512, 512, 64] by
    [3, 3, 64, 64], an offset-carrying stream): its result does not depend
    on the process's TF32 flag (its exact-product passes set TF32 locally),
    each pass count against the float64 conv of the same operands, and the
    ms of 1, 2 and 3 passes beside the bf16 conv's and the fp32 conv's (TF32
    off)."""
    from endosr_torch.nn.layers import centered_conv, conv2d_nhwc

    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn((8, 512, 512, 64), generator=gen, device="cuda") * 0.3 + 2.0
    w = torch.randn((3, 3, 64, 64), generator=gen, device="cuda") * 0.05
    b = torch.randn((64,), generator=gen, device="cuda")
    with torch.inference_mode():
        flag = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            on = centered_conv(x, w, b, torch.bfloat16, 3)
        finally:
            torch.backends.cudnn.allow_tf32 = flag
        off = centered_conv(x, w, b, torch.bfloat16, 3)
        if not torch.equal(on, off):
            raise AssertionError("centered_conv depends on the TF32 flag: "
                                 f"{float((on - off).abs().max())}")
        ref = (conv2d_nhwc(x[:2].double(), w.double(), 1, torch.float64)
               + b.double())
        out = {"max_rel_err_vs_f64": {}, "ms": {}}
        for p in (1, 2, 3):
            y = centered_conv(x[:2], w, b, torch.bfloat16, p).double()
            out["max_rel_err_vs_f64"][p] = float(
                (y - ref).abs().max() / ref.abs().max())
        del ref, on, off
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        for p in (1, 2, 3):
            out["ms"][f"centered_{p}"] = cuda_ms(
                lambda p=p: centered_conv(x, w, b, torch.bfloat16, p), 10)
        out["ms"]["bf16"] = cuda_ms(
            lambda: conv2d_nhwc(xb, wb, 1) + b.to(torch.bfloat16), 10)
        out["ms"]["fp32"] = cuda_ms(lambda: conv2d_nhwc(x, w, 1) + b, 10)
    errs = out["max_rel_err_vs_f64"]
    log("[x2/x3] centered_conv [8,512,512,64]×[3,3,64,64], bf16 passes: "
        f"the same bits with the process's TF32 on and off; max |Δ|/max|ref| "
        f"against float64: " + ", ".join(f"{p} pass {e:.3e}"
                                         for p, e in errs.items())
        + "; ms: " + ", ".join(f"{k} {v:.3f}" for k, v in out["ms"].items())
        + f" (fp32: TF32 off); {gpu_line()}")
    if not (errs[3] <= 2e-5 and errs[1] <= 2e-2):
        raise AssertionError(f"centered_conv errors {errs}")
    return out


def _x2_opt(precision, net):
    return {"is_train": False, "model": "sftmd_depthCond", "scale": 2,
            "precision": precision, "eval_bucket_multiple": 0,
            "datasets": {"test": {"depthMaskNum": 10}}, "network_G": net,
            "path": {}, "train": {"manual_seed": 0}}


def serve_x2(torch, counters):
    """Phase 8c: the ×2 Kvasir network at full width (the ×2 YAML's
    ``network_G``: nb 16, every block a depth block, latent 32), batch 8 of
    LQ 512² → SR 1024², unbucketed, seeded weights, against a reference
    of fp32 ``preset: plain`` (no kernel launched, asserted; TF32 off) on
    the same weights and requests, in fp32 (max |Δ| ≤ ``X2_PLAIN_TOL``),
    bf16c3, bf16c, mixed and bf16 (mismatch-PSNR over all values, as the
    JAX package measures it, at least ``X2_FLOOR``; also logged over the
    values neither run clamps). Per precision: a warm-up request, then 2
    requests with the
    launch counts set to 0 just before and read just after (counts and
    routes asserted), host ms; one more request under ``torch.profiler``
    (device busy ms); SR finite, fp32, of the right shape, in [0, 1].
    Returns ({path label: launches}, readings)."""
    from pathlib import Path

    import yaml

    from endosr_torch.models.f_depthcond import FModelDepthCond
    from endosr_torch.ops.masks import depth_masks
    from endosr_torch.tools.profile_serving import device_kernels

    net = yaml.safe_load((Path(__file__).resolve().parent / X2_YAML)
                         .read_text())["network_G"]
    log(f"[x2] reduced: {X2_YAML} network_G.remat_blocks: "
        f"{net.pop('remat_blocks')!r} → unset (a training field; serving)")
    h, w = X2_LR
    gen = torch.Generator(device="cuda").manual_seed(3)
    reqs = []
    for _ in range(2):
        dep = torch.rand((8, h, w, 1), generator=gen, device="cuda")
        reqs.append({"LQ": torch.rand((8, h, w, 3), generator=gen,
                                      device="cuda"),
                     "Depth": dep,
                     "DepthMaskList": depth_masks(dep[..., 0], True, 10)})
    # the reference: fp32 ``preset: plain`` (no kernel), TF32 off, in
    # slices of X2_PLAIN_BATCH images (the forward is per image)
    plain = FModelDepthCond(_x2_opt("fp32", {**net, "preset": "plain"}))
    sd = {k: v.clone() for k, v in plain.netG.state_dict().items()}
    zero_counts(counters)
    t0, ref = time.perf_counter(), []
    for r in reqs:
        parts = []
        for k in range(0, 8, X2_PLAIN_BATCH):
            plain.feed_data({key: x[k:k + X2_PLAIN_BATCH]
                             for key, x in r.items()})
            parts.append(plain.test().cpu())
        ref.append(torch.cat(parts))
    plain_s = time.perf_counter() - t0
    del plain
    torch.cuda.empty_cache()
    if any(c.launches for c in counters):
        raise AssertionError("[x2] the preset: plain reference launched "
                             + ", ".join(f"{c.__name__} {c.launches}"
                                         for c in counters if c.launches))
    log(f"[x2] reference: fp32 preset: plain, no kernel launched, "
        f"{len(reqs)} requests in slices of {X2_PLAIN_BATCH} images, "
        f"{plain_s:.1f} s")
    launches, numbers = {}, {"plain_reference_s": plain_s}
    for precision in ("fp32", "bf16c3", "bf16c", "mixed", "bf16"):
        label = f"x2 {precision}"
        model = FModelDepthCond(_x2_opt(precision, net))
        model.netG.load_state_dict(sd)

        def request(r):
            # the SR lives only where the caller keeps it: a 96 MB output
            # kept on the card from one request to the next can split one
            # of the 26 GiB blocks the fp32 request needs
            model.feed_data(r)
            out = model.test()
            model.fake_SR = model.fake_H = None
            return out

        request(reqs[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counters)
        lat, outs = [], []
        for r in reqs:
            t = time.perf_counter()
            sr = request(r)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t)
            outs.append(sr.cpu())
            del sr
        got = {c.__name__: c.launches for c in counters}
        routes = {c.__name__: dict(c.routes) for c in counters
                  if hasattr(c, "routes")}
        want, want_routes = X2_WANT[precision]
        for c in counters:
            if got[c.__name__] != want.get(c.__name__, 0) * len(reqs):
                raise AssertionError(f"[{label}] {c.__name__}: "
                                     f"{got[c.__name__]} launches in "
                                     f"{len(reqs)} requests, want "
                                     f"{want.get(c.__name__, 0)} each")
        for name, route in want_routes.items():
            took = {**dict.fromkeys(routes[name], 0), route: got[name]}
            if routes[name] != took:
                raise AssertionError(f"[{label}] {name} routes "
                                     f"{routes[name]}, want {took}")
        wall, rows = device_kernels(torch, lambda: request(reqs[0]), 1)
        busy = sum(r[0] for r in rows) / 1e3
        sr = outs[0]
        if (tuple(sr.shape) != (8, 2 * h, 2 * w, 3) or sr.dtype != torch.float32
                or not bool(torch.isfinite(sr).all())
                or float(sr.min()) < 0.0 or float(sr.max()) > 1.0):
            raise AssertionError(f"[{label}] SR {tuple(sr.shape)} {sr.dtype} "
                                 f"[{float(sr.min())}, {float(sr.max())}]")
        rec = {"ms": [x * 1e3 for x in lat], "profiled_wall_ms": wall * 1e3,
               "device_ms": busy,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        host = [o.cpu() for o in outs]
        rec["max_abs_vs_plain"] = max(float((a - b).abs().max())
                                      for a, b in zip(host, ref))
        rec["psnr_db"] = [psnr(a, b) for a, b in zip(host, ref)]
        rec["psnr_unclamped_db"] = [_psnr_unclamped(a.numpy(), b.numpy())
                                    for a, b in zip(host, ref)]
        numbers[precision] = rec
        launches[label] = got
        log(f"[{label}] batch 8, LQ {h}×{w} → SR {2 * h}×{2 * w}: "
            + ", ".join(f"{c}: {n}" for c, n in got.items() if n)
            + f" launches in {len(reqs)} requests ("
            + ", ".join(f"{k} {v}" for k, v in want_routes.items())
            + "); host ms " + ", ".join(f"{x:.2f}" for x in rec["ms"])
            + f"; device busy {busy:.3f} ms of a profiled {wall * 1e3:.3f} ms"
            + f"; peak {rec['peak_gib']:.2f} GiB"
            + "; vs fp32 plain " + ", ".join(f"{d:.2f}" for d in rec["psnr_db"])
            + " dB (unclamped: " + ", ".join(
                f"{d:.2f} dB over {f:.3f}" for d, f in rec["psnr_unclamped_db"])
            + f"), max|Δ| {rec['max_abs_vs_plain']:.3e}")
        top = ", ".join(f"{k[:60]} {us / 1e3:.3f}" for us, _, k in rows[:6])
        log(f"[{label}] first device items (ms): {top}")
        del model, outs
        torch.cuda.empty_cache()
        if precision == "fp32":
            if not rec["max_abs_vs_plain"] <= X2_PLAIN_TOL:
                raise AssertionError(f"[{label}] max|Δ| against fp32 plain "
                                     f"{rec['max_abs_vs_plain']} > "
                                     f"{X2_PLAIN_TOL}")
        elif not min(rec["psnr_db"]) >= X2_FLOOR[precision]:
            raise AssertionError(f"[{label}] PSNR against fp32 plain "
                                 f"{rec['psnr_db']} dB < "
                                 f"{X2_FLOOR[precision]} dB")
    return launches, numbers


def write_endoscene(root, scale=3, n=X3_N, split="test.txt", crop=False):
    """Phase 8d's synthetic CVC-EndoSceneStill test split, written with
    ``cv2``: ``n`` frames of GT 574×500, LR under ``LR/x<scale>/`` the
    MATLAB bicubic of the frame cropped to a multiple of ``scale`` (×3:
    191×166), ``<stem>_disp.npy`` depth, and ``split`` naming the frames.
    ``crop``: the GT file holds the cropped frame (training takes whole
    frames, and its loss needs GT = ``scale`` × LR; phase 9a)."""
    import numpy as np

    import cv2

    from endosr_torch.ops.color import modcrop

    rng = np.random.default_rng(11)
    for sub in ("HR", f"LR/x{scale}", "depth"):
        (root / sub).mkdir(parents=True)
    names = [f"{i + 1}.png" for i in range(n)]
    for name in names:
        gt = _smooth_u8(np, rng, *X3_GT)
        lr = _bicubic(np, modcrop(gt, scale).astype(np.float32) / 255.0,
                      1 / scale)
        lr = np.clip(lr * 255.0, 0, 255).round().astype(np.uint8)
        cv2.imwrite(str(root / "HR" / name), modcrop(gt, scale) if crop else gt)
        cv2.imwrite(str(root / f"LR/x{scale}" / name), lr)
        np.save(root / "depth" / f"{name[:-4]}_disp.npy",
                rng.random((1, 1) + lr.shape[:2], dtype=np.float32))
    (root / split).write_text("".join(n + "\n" for n in names))


def eval_x3(torch, counters):
    """Phase 8d: ``python -m endosr_torch.test`` through ``main`` on the ×3
    EndoScene network (the ×3 YAML's ``network_G``: nb 16, every block a
    depth block, latent 256) and its dataset block (``EndoScene_Depth``, a
    split file, LR under ``x3/``) on a synthetic frame set, ``precision``
    unset: ``bf16c3`` auto-selected, bucketing off. Each image's ``test``
    runs with the launch counts set to 0 just before and read just after
    (counts and routes asserted); the TSV, the PNGs at the frame size, and
    each SR against an fp32 serve of the same weights over the values
    neither run clamps. The fp32 serve is ``preset: plain`` (no kernel
    launched, asserted), so the floor holds the kernels against their plain
    versions. Returns ({path label: launches}, readings)."""
    import shutil
    from pathlib import Path

    import cv2
    import yaml

    import endosr_torch.test as entry_test
    from endosr_torch.config import options as option
    from endosr_torch.data import create_dataloader, create_dataset
    from endosr_torch.models import create_model
    from endosr_torch.models.f_depthcond import FModelDepthCond

    repo = Path(__file__).resolve().parent
    root = repo / X3_ROOT
    shutil.rmtree(root, ignore_errors=True)
    write_endoscene(root / "data")
    src = yaml.safe_load((repo / X3_YAML).read_text())
    net = {**src["network_G"]}
    weights = FModelDepthCond({"model": "sftmd_depthCond", "scale": 3,
                               "network_G": net,
                               "path": {"models": str(root / "init")}}).save(0)
    data = root / "data"
    ds = {**src["datasets"]["val"], "name": "EndoScene_x3_test",
          "dataset_split_list": str(data / "test.txt"),
          "dataroot_GT": str(data / "HR"), "dataroot_LQ": str(data / "LR"),
          "dataroot_depthMap": str(data / "depth")}
    y = yaml.safe_load((repo / "options/test/test_depthNet.yml").read_text())
    log(f"[x3] options/test/test_depthNet.yml with scale 8 → 3, datasets "
        f"the ×3 YAML's val block (data roots on the synthetic tree), "
        f"network_G the ×3 YAML's, path.root and pretrain_model_G set; "
        f"precision unset")
    y.update(scale=3, datasets={"test_1": ds}, network_G=net)
    y["path"].update(root=str(root / "eval"), pretrain_model_G=weights)
    test_yaml = root / "test_x3.yml"
    test_yaml.write_text(yaml.safe_dump(y))

    taps = EntryTaps(torch, counters)
    taps.serving = "x3 eval"
    uninstall = taps.install()
    t0 = time.perf_counter()
    try:
        model = entry_test.main(["-opt_F", str(test_yaml)])
    finally:
        uninstall()
    secs = time.perf_counter() - t0
    precision = model.opt["precision"]
    centered, bucket = model.netG.centered_convs, model._bucket()
    del model
    calls = taps.calls["x3 eval"]
    if precision != "bf16c3" or centered != 3 or bucket != 0:
        raise AssertionError(f"[x3] precision {precision}, centered "
                             f"{centered}, bucket {bucket}")
    taps.check("x3 eval", calls, X3_WANT, X3_ROUTES)
    res = root / "eval/results/DepthNet_test"
    names = [f"{i + 1}" for i in range(X3_N)]
    rows = (res / "result_x3.tsv").read_text().splitlines()
    if (rows[0] != "Name\tPSNR\tSSIM\tPSNR_Y\tSSIM_Y"
            or [r.split("\t")[0] for r in rows[1:]] != names + ["Average"]
            or not all(math.isfinite(float(v)) for r in rows[1:]
                       for v in r.split("\t")[1:])):
        raise AssertionError(f"[x3] result_x3.tsv: {rows}")
    crop = (X3_GT[0] // 3 * 3, X3_GT[1] // 3 * 3, 3)
    pngs = sorted((res / "x3").glob("*.png"))
    if ([p.stem for p in pngs] != names or any(
            getattr(cv2.imread(str(p), cv2.IMREAD_UNCHANGED), "shape", None)
            != crop for p in pngs)):
        raise AssertionError(f"[x3] PNGs {pngs}")

    opt = option.dict_to_nonedict(option.parse(str(test_yaml), is_train=False))
    opt["precision"] = "fp32"
    opt["network_G"]["preset"] = "plain"
    m32 = create_model(opt)
    ref = []
    ds_opt = opt["datasets"]["test_1"]
    zero_counts(counters)
    for batch in create_dataloader(create_dataset(ds_opt), ds_opt):
        m32.feed_data(batch)
        ref.append(m32.test().float().cpu())
    del m32
    if any(c.launches for c in counters):
        raise AssertionError("[x3] the preset: plain reference launched "
                             + ", ".join(f"{c.__name__} {c.launches}"
                                         for c in counters if c.launches))
    dbs, shares = zip(*(_psnr_unclamped(c["sr"].numpy(), r.numpy())
                        for c, r in zip(calls, ref)))
    ms = [c["secs"] * 1e3 for c in calls]
    log(f"[x3] test.main, EndoScene ×3, {X3_N} frames of GT "
        f"{X3_GT[0]}×{X3_GT[1]} (SR {crop[0]}×{crop[1]}), bf16c3 "
        f"unbucketed: " + ", ".join(f"{x:.1f}" for x in ms)
        + f" ms an image (forward, host clock), {secs:.1f} s in all; "
        f"bf16c3 vs fp32 plain " + ", ".join(f"{d:.2f}" for d in dbs)
        + " dB over the unclamped " + ", ".join(f"{x:.4f}" for x in shares)
        + f" of the values; TSV {rows[-1]}; {gpu_line()}")
    if not min(dbs) >= 40.0:
        raise AssertionError(f"[x3] bf16c3 vs fp32 {dbs} dB")
    launches = {"x3 eval": {c.__name__: sum(r["launches"][c.__name__]
                                            for r in calls)
                            for c in counters}}
    return launches, {"ms_per_image": ms, "main_s": secs,
                      "psnr_unclamped_db": dbs, "unclamped_share": shares,
                      "tsv": rows}


def serving_x2_x3(torch, counters):
    """Phase 8: ×2 / ×3 serving (8a–8d). Returns ({path label:
    launches}, readings)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[x2/x3] device memory held at the start: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    t0 = time.perf_counter()
    numbers = {"kernel_max_abs_err": path_kernel_checks(torch),
               "centered_conv": centered_conv_times(torch)}
    launches, numbers["x2"] = serve_x2(torch, counters)
    x3, numbers["x3"] = eval_x3(torch, counters)
    launches.update(x3)
    numbers["seconds"] = time.perf_counter() - t0
    log(f"[x2/x3] phase 8 took {numbers['seconds']:.1f} s")
    return launches, numbers


TRAIN9_ROOT = "build/train9"    # under the repository root, git-ignored
TRAIN9_STEPS = 3
TRAIN9_N = 16                   # training pairs (Kvasir) or frames (EndoScene)
TRAIN9_GT = 1024                # the Kvasir YAMLs' GT_size
_T = "options/train/train_depthNet_SEAN_depthMask_"
# each shipped training YAML but ×8's (phase 7's): (the YAML, its scale,
# the seed it trains with, the launches of a step, their routes). The
# EndoScene YAMLs train on whole 574×500 frames, and with ``use_rot`` a
# batch that mixes upright and transposed frames does not stack (C7, in
# the JAX loader as here): their seed is the first at which no batch of
# the run's 3 steps mixes them (4 loader workers, 16 frames; found by
# replaying the workers' augmentation draws). None: the YAML's own seed.
TRAIN9 = {
    "x2 train": (_T + "x2.yml", 2, None, {"output_stage": 1},
                 {"output_stage": "vec16"}),
    "x4 train": (_T + "x4.yml", 4, None, {"output_stage_x8": 1},
                 {"output_stage_x8": "vec16"}),
    "x2 endoscene train": (
        _T + "endoscene_x2.yml", 2, 234137,
        {"style_blend_dot": 2, "output_stage": 1},
        {"style_blend_dot": "cuda_core", "output_stage": "vec16"}),
    # a row of 166·27 values is no multiple of 16 bytes: route v1
    "x3 endoscene train": (
        _T + "endoscene_x3.yml", 3, 232,
        {"style_blend_dot": 2, "output_stage": 1},
        {"style_blend_dot": "cuda_core", "output_stage": "v1"}),
    "x4 endoscene train": (
        _T + "endoscene_x4.yml", 4, 234137,
        {"style_blend_dot": 2, "output_stage_x8": 1},
        {"style_blend_dot": "cuda_core", "output_stage_x8": "vec16"}),
}
# the ablations at ×4 (the ×4 YAML's network_G with the field set)
ABL9 = {"ablate_depth_matrix": {"ablate_depth_matrix": True},
        "ablate_depth_block": {"ablate_depth_block": True},
        "baseline": {"which_ResBlk_depth": []}}
# phase 9c: (label, the YAML, LQ of the batch-2 step, the plain path's
# network_G keys, the step's launches and routes)
_REMAT_PLAIN = {"preset": "plain", "net_kw": {"remat_blocks": True}}
GRADS9 = (
    ("x2", ("kvasir", 2), (512, 512), _REMAT_PLAIN,
     ({"output_stage": 1}, {"output_stage": "vec16"})),
    ("x3 endoscene", ("endoscene", 3), (191, 166), None,
     ({"style_blend_dot": 2, "output_stage": 1},
      {"style_blend_dot": "cuda_core", "output_stage": "v1"})),
    ("x4", ("kvasir", 4), (256, 256), _REMAT_PLAIN,
     ({"output_stage_x8": 1}, {"output_stage_x8": "vec16"})))
ABL9_LR = (127, 127)        # a request; the depth-matrix ablation's encoder
ABL9_TRAIN_LR = (63, 63)    # gives the feature's size back for odd sizes
ABL9_WANT = ({"output_stage_x8": 1}, {"output_stage_x8": "vec16"})
ABL9_BF16_FLOOR = 40.0      # bf16 vs fp32 on the same weights (§2)


def _run_rate(yaml_path, steps):
    """The training loader of ``yaml_path`` over the batches of a run of
    ``steps`` steps (its epochs in order, the cache filled first and the
    workers started each epoch): images/s."""
    from endosr_torch.config import options as option
    from endosr_torch.data import create_dataloader, create_dataset

    opt = option.dict_to_nonedict(option.parse(yaml_path, is_train=True))
    ds_opt = opt["datasets"]["train"]
    loader = create_dataloader(create_dataset(ds_opt), ds_opt, opt,
                               pin_memory=True)
    t, n, epoch = time.perf_counter(), 0, 0
    while n < steps:
        loader.set_epoch(epoch)
        for b in loader:
            n += 1
            if n == steps:
                images = n * b["LQ"].shape[0]
                break
        epoch += 1
    return images / (time.perf_counter() - t)


def train_yamls(torch, counters):
    """Phase 9a: ``python -m endosr_torch.train`` (through ``main``) on
    each shipped training YAML other than ×8 (phase 7's), fp32 as they
    leave it, at their own batch, sizes and ``remat_blocks``: ×2 Kvasir
    (batch 2, LQ 512² → GT 1024², ``remat_blocks``), ×4 Kvasir (batch 8,
    LQ 256², ``remat_blocks``), and EndoScene ×2 / ×3 / ×4 (batch 8 / 4 /
    8, whole 574×500 frames cut to the scale). Each YAML's data roots,
    ``path.root``, ``data_num``, ``niter``, ``val_freq``,
    ``save_checkpoint_freq``, ``print_freq`` and (EndoScene, see
    ``TRAIN9``) ``manual_seed`` are changed, each logged as ``reduced``.
    Every step runs with the launch counts set to 0 just before it and
    read just after: counts and routes asserted, losses finite. Logged: ms
    a step (steps 2–3), peak device memory, the loader's images/s over the
    run's batches. Returns ({label: launches}, readings)."""
    import gc
    import shutil
    from pathlib import Path

    import endosr_torch.train as entry_train

    repo = Path(__file__).resolve().parent
    root = repo / TRAIN9_ROOT
    shutil.rmtree(root, ignore_errors=True)
    taps = EntryTaps(torch, counters)
    launches, numbers = {}, {}
    for label, (src, scale, seed, want, routes) in TRAIN9.items():
        tag = label.replace(" ", "_")
        data = root / f"data_{tag}"
        t0 = time.perf_counter()
        changes = {}
        if "endoscene" in label:
            write_endoscene(data, scale, TRAIN9_N, "train.txt", crop=True)
            tree = {"dataroot_GT": str(data / "HR"),
                    "dataroot_LQ": str(data / "LR"),
                    "dataroot_depthMap": str(data / "depth"),
                    "dataset_split_list": str(data / "train.txt")}
            changes["train.manual_seed"] = seed
        else:
            lr = TRAIN9_GT // scale
            write_kvasir(data, scale, {"train": (lr, lr)},
                         {"train": TRAIN9_N})
            tree = {"dataroot_GT": str(data / "HR/train"),
                    "dataroot_LQ": str(data / "LR/train"),
                    "dataroot_depthMap": str(data / "depth/train")}
        write_s = time.perf_counter() - t0
        changes.update({f"datasets.{ph}.{k}": v for ph in ("train", "val")
                        for k, v in tree.items()})
        changes.update({
            "datasets.train.data_num": TRAIN9_N, "path.root": str(root / tag),
            "train.niter": TRAIN9_STEPS, "train.val_freq": 1000,
            "logger.save_checkpoint_freq": TRAIN9_STEPS,
            "logger.print_freq": 1})
        yml = _derive(repo / src, root / f"{tag}.yml", changes, "train9")
        rate = _run_rate(yml, TRAIN9_STEPS)
        taps.training = label
        uninstall = taps.install()
        try:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            model = entry_train.main(["-opt_F", yml])
            main_s = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            remat = model.netG.remat_blocks
            del model
        finally:
            uninstall()
        gc.collect()
        torch.cuda.empty_cache()
        calls = taps.calls[label]
        taps.check(label, calls, want, routes)
        losses = [r["logs"]["l_all"] for r in calls]
        if len(calls) != TRAIN9_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"[{label}] {len(calls)} steps, losses "
                                 f"{losses}")
        exp = next((root / tag / "experiments").iterdir())
        if not (exp / "models" / f"{TRAIN9_STEPS}_G.pth").is_file():
            raise AssertionError(f"[{label}] no checkpoint at step "
                                 f"{TRAIN9_STEPS}")
        ms = [r["secs"] * 1e3 for r in calls]
        step_ms = sum(ms[1:]) / (len(ms) - 1)
        numbers[label] = {"ms": ms, "ms_per_step": step_ms, "peak_gib": peak,
                          "loader_images_per_s": rate, "losses": losses,
                          "main_s": main_s, "data_s": write_s,
                          "remat_blocks": remat}
        launches[label] = {c.__name__: sum(r["launches"][c.__name__]
                                           for r in calls)
                           for c in counters}
        log(f"[{label}] train.main, fp32, remat_blocks {remat}: "
            + ", ".join(f"{k} {v}" for k, v in want.items())
            + " launches a step (" + ", ".join(f"{k} {v}"
                                               for k, v in routes.items())
            + f"); step ms " + ", ".join(f"{x:.1f}" for x in ms)
            + f" ({step_ms:.1f} a step after the first, host clock, "
            f"synchronised); peak {peak:.2f} GiB; loader {rate:.1f} images/s "
            f"over the run's batches (cache fill and workers' start "
            f"included); l_all {losses}; {main_s:.1f} s in main, data "
            f"{write_s:.1f} s; {gpu_line()}")
    return launches, numbers


def _yaml_net(name):
    """The ``network_G`` block of the repo's YAML ``name``."""
    from pathlib import Path

    import yaml

    path = Path(__file__).resolve().parent / name
    return yaml.safe_load(path.read_text())["network_G"]


def _check_step(label, run, want, routes):
    """A ``parity_runs`` step launched ``want`` (others 0) on ``routes``."""
    for name, n in run["launches"].items():
        if n != want.get(name, 0):
            raise AssertionError(f"[{label}] {name} {n} launches, want "
                                 f"{want.get(name, 0)}")
    for name, route in routes.items():
        took = {**dict.fromkeys(run["routes"][name], 0),
                route: run["launches"][name]}
        if run["routes"][name] != took:
            raise AssertionError(f"[{label}] {name} routes "
                                 f"{run['routes'][name]}, want {took}")


def remat_and_gradients(torch, counters):
    """Phase 9b and 9c. (b) The ×2 Kvasir YAML's step (batch 2, LQ 512² →
    GT 1024², fp32) with its ``remat_blocks`` and without it, from the
    same weights and batch: the peak device memory with it below the peak
    without it; the two held to each other by phase 6b's rule (the graphs
    differ: per-block branches against the hoisted lazy ones). (c) The
    kernel path's step at full width against ``preset: plain`` of the
    same net (``remat_blocks`` kept) by phase 6b's rule with the one-ulp
    nudges on the plain side: ×2 (that batch), ×3 EndoScene (the ×3 YAML's
    net, batch 2 of a frame's LQ 191×166) and ×4 Kvasir (``remat_blocks``,
    batch 2, LQ 256²); at ×3 also :func:`step_controls` and
    :func:`rerun_check`. Returns ({label:
    launches}, readings)."""
    from endosr_torch.models.recipes import TRAIN_YAMLS, train_opt

    launches, numbers = {}, {}
    for label, key, lr_hw, plain, want in GRADS9:
        variants = {"kernels": {}}
        if label == "x2":
            variants["hoisted"] = {"remat_blocks": False}
        t0 = time.perf_counter()
        opt_of = functools.partial(train_opt, TRAIN_YAMLS[key], "fp32")
        batch = parity_batch(torch, key[1], lr_hw)
        runs = parity_runs(torch, opt_of, batch, variants, plain, counters)
        secs = time.perf_counter() - t0
        _check_step(f"{label} grads", runs["kernels"], *want)
        for lab, r in runs.items():
            if lab != "kernels" and lab != "hoisted" and any(
                    r["launches"].values()):
                raise AssertionError(f"[{label} grads] {lab} launched "
                                     f"{r['launches']}")
        rec = {"grads": train_parity(
            torch, runs, f"{label} grads: ×{key[1]} YAML's net, kernels vs "
            "preset: plain"),
            "step_ms": {lab: r["secs"] * 1e3 for lab, r in runs.items()},
            "peak_gib": {lab: r["peak_gib"] for lab, r in runs.items()},
            "seconds": secs}
        name = {"x2": "x2 remat", "x3 endoscene": "x3 endoscene grads",
                "x4": "x4 remat grads"}[label]
        launches[name] = runs["kernels"]["launches"]
        if label == "x3 endoscene":
            rec["controls"] = step_controls(torch, runs, opt_of(), batch,
                                            f"{label} grads")
            rec["rerun"] = rerun_check(torch, runs, opt_of(preset="plain"),
                                       batch, f"{label} grads")
        if label == "x2":
            _check_step("x2 hoisted", runs["hoisted"],
                        {"style_blend_dot": 2, "output_stage": 1},
                        {"style_blend_dot": "cuda_core",
                         "output_stage": "vec16"})
            launches["x2 hoisted"] = runs["hoisted"]["launches"]
            rec["remat_vs_hoisted"] = train_parity(
                torch, runs, "x2 remat: remat_blocks off (hoisted lazy "
                "branches) vs on", ref="kernels", got="hoisted")
            on, off = (runs[k]["peak_gib"] for k in ("kernels", "hoisted"))
            log(f"[x2 remat] ×2 YAML step, batch 2, LQ 512² → GT 1024², "
                f"fp32: peak {on:.2f} GiB with remat_blocks, {off:.2f} GiB "
                f"without ({(1 - on / off) * 100:.1f} % less); step "
                f"{runs['kernels']['secs'] * 1e3:.1f} ms with, "
                f"{runs['hoisted']['secs'] * 1e3:.1f} ms without (one step "
                f"each, host clock); {gpu_line()}")
            if not on < off:
                raise AssertionError(f"[x2 remat] peak {on:.2f} GiB with "
                                     f"remat_blocks, {off:.2f} without")
        numbers[label] = rec
        del runs
        torch.cuda.empty_cache()
    return launches, numbers


def rerun_check(torch, runs, opt, batch, label):
    """The plain step of ``runs`` again from the same weights on
    ``batch``: once as ``parity_step`` takes it, every gradient equal to
    the first run's (asserted: a reading of phase 6b's rule is then the
    same from run to run); twice with cuDNN's default algorithms, the
    count of gradient tensors that differ between the two (read).
    Returns {"deterministic": tensors differing, "default": ...}."""
    first, start = runs["plain"]["grads"], runs["plain"]["start"]
    again = parity_step(torch, opt, start, batch)["grads"]
    one, two = (parity_step(torch, opt, start, batch, deterministic=False)
                ["grads"] for _ in range(2))
    out = {"deterministic": sum(not torch.equal(first[k], again[k])
                                for k in first),
           "default": sum(not torch.equal(one[k], two[k]) for k in one)}
    log(f"[{label} rerun] the plain step again: {out['deterministic']} of "
        f"{len(first)} gradient tensors differ with cuDNN's deterministic "
        f"algorithms, {out['default']} between two runs with its default "
        "ones")
    if out["deterministic"]:
        raise AssertionError(f"[{label} rerun] {out['deterministic']} "
                             "gradient tensors differ between two runs of "
                             "the same step")
    return out


def vjp_controls(torch):
    """Two wrong backwards of ``style_blend_dot`` that the checks are
    shown against: {label: a stand-in for ``style_blend_vjp``}. "bf16":
    the backward's products from bf16-rounded operands (the bias's sum
    from the rounded g); "no bias term": the bias's gradient dropped."""
    from endosr_torch.kernels import style_dot

    right = style_dot.style_blend_vjp

    def bf16(shifted, v, n_conv, conv_dtype, bias_dtype, g, hwbc=False):
        b = torch.bfloat16
        gs, gv, gc, gb = right(shifted.to(b), v.to(b), n_conv, b, bias_dtype,
                               g.to(b), hwbc)
        return (gs.to(shifted.dtype), gv.to(v.dtype),
                tuple(c.to(conv_dtype) for c in gc), gb)

    def no_bias(*args):
        gs, gv, gc, gb = right(*args)
        return gs, gv, gc, torch.zeros_like(gb)

    return {"bf16": bf16, "no bias term": no_bias}


@contextlib.contextmanager
def vjp_swapped(vjp):
    """``style_blend_dot``'s backward is ``vjp`` inside the block."""
    from endosr_torch.kernels import style_dot

    right, style_dot.style_blend_vjp = style_dot.style_blend_vjp, vjp
    try:
        yield
    finally:
        style_dot.style_blend_vjp = right


def step_controls(torch, runs, opt, batch, label):
    """What phase 6b's rule sees of a wrong ``style_blend_dot`` backward
    (``vjp_controls``): the kernel step of ``runs`` again, from the same
    weights on ``batch``, with each control as the backward, held to the
    plain step by :func:`parity_readings`. "no bias term" must be
    rejected; "bf16" is read, not asserted: its distance sits near the
    per-tensor bounds (the nudges' reach), and 9f holds the backward's
    precision. Returns {control: readings, with its distance from the
    right kernel step (all gradients, norm-relative) and the failed
    clauses}."""
    out = {}
    for name, vjp in vjp_controls(torch).items():
        with vjp_swapped(vjp):
            run = parity_step(torch, opt, runs["kernels"]["start"], batch)
        readings, fails = parity_readings(
            torch, {**runs, "control": run}, f"{label} control: {name}",
            got="control")
        readings["vs_kernels"] = _nrel(run["grads"], runs["kernels"]["grads"])
        readings["rejected_by"] = fails
        log(f"[{label} control: {name}] all gradients "
            f"{readings['vs_kernels']:.3g} norm-relative from the right "
            f"kernel step; against plain: {readings['grad_nrel']:.3g} (tol "
            f"{readings['grad_nrel_tol']:.3g}); "
            + (f"rejected: {'; '.join(fails)[:600]}" if fails
               else "accepted"))
        out[name] = readings
        del run
        torch.cuda.empty_cache()
    if not out["no bias term"]["rejected_by"]:
        raise AssertionError(f"[{label}] phase 6b's rule accepts a "
                             "style_blend_dot backward without its bias term")
    return out


def ablations(torch, counters):
    """Phase 9d: ``ablate_depth_matrix``, ``ablate_depth_block`` and the
    baseline (no depth block) at ×4 on the ×4 YAML's network (nb 16,
    latent 256, its ``remat_blocks``), seeded weights: one fp32 request
    (batch 8, LQ 127², unbucketed) within ``X2_PLAIN_TOL`` of its ``preset:
    plain`` twin (no kernel launched, asserted); one bf16 request, its PSNR
    against the fp32 one at least ``ABL9_BF16_FLOOR``; one fp32 training
    step (the ×4 YAML's ``train:`` block, batch 2, LQ 63²) against
    ``preset: plain`` by phase 6b's rule. Counts set to 0 just before each
    request and step and read just after: ``output_stage_x8`` 1 each
    (``vec16``), nothing else. Returns ({variant: launches}, readings)."""
    from endosr_torch.models.f_depthcond import FModelDepthCond
    from endosr_torch.models.recipes import TRAIN_YAMLS, train_opt
    from endosr_torch.ops.masks import depth_masks

    net4 = _yaml_net(_T + "x4.yml")
    h, w = ABL9_LR
    gen = torch.Generator(device="cuda").manual_seed(6)
    dep = torch.rand((8, h, w, 1), generator=gen, device="cuda")
    req = {"LQ": torch.rand((8, h, w, 3), generator=gen, device="cuda"),
           "Depth": dep, "DepthMaskList": depth_masks(dep[..., 0], True, 10)}
    launches, numbers = {}, {}
    for variant, fields in ABL9.items():
        net = {**net4, **fields}

        def serve_opt(precision, **more):
            return {"is_train": False, "model": "sftmd_depthCond", "scale": 4,
                    "precision": precision, "eval_bucket_multiple": 0,
                    "datasets": {"test": {"depthMaskNum": 10}},
                    "network_G": {**net, **more}, "path": {},
                    "train": {"manual_seed": 0}}

        got = dict.fromkeys((c.__name__ for c in counters), 0)
        outs, ms = {}, {}
        sd = None
        for precision, more in (("plain", {"preset": "plain"}), ("fp32", {}),
                                ("bf16", {})):
            m = FModelDepthCond(serve_opt("fp32" if precision == "plain"
                                          else precision, **more))
            if sd is None:
                sd = {k: v.clone() for k, v in m.netG.state_dict().items()}
            m.netG.load_state_dict(sd)
            m.feed_data(req)
            m.test()                              # warm-up
            torch.cuda.synchronize()
            zero_counts(counters)
            t = time.perf_counter()
            m.feed_data(req)
            sr = m.test().clone()
            torch.cuda.synchronize()
            ms[precision] = (time.perf_counter() - t) * 1e3
            run = {"launches": {c.__name__: c.launches for c in counters},
                   "routes": {c.__name__: dict(c.routes) for c in counters
                              if hasattr(c, "routes")}}
            _check_step(f"{variant} {precision}", run,
                        *(({}, {}) if precision == "plain" else ABL9_WANT))
            for k, v in run["launches"].items():
                got[k] += v
            if (tuple(sr.shape) != (8, 4 * h, 4 * w, 3)
                    or not bool(torch.isfinite(sr).all())):
                raise AssertionError(f"[{variant} {precision}] SR "
                                     f"{tuple(sr.shape)}")
            outs[precision] = sr
            del m
            torch.cuda.empty_cache()
        err = float((outs["fp32"] - outs["plain"]).abs().max())
        db = psnr(outs["bf16"], outs["fp32"])
        unclamped = float(((outs["fp32"] > 0) & (outs["fp32"] < 1))
                          .float().mean())
        runs = parity_runs(
            torch, functools.partial(train_opt, TRAIN_YAMLS[("kvasir", 4)],
                                     "fp32", **fields),
            parity_batch(torch, 4, ABL9_TRAIN_LR), None, _REMAT_PLAIN,
            counters)
        _check_step(f"{variant} step", runs["kernels"], *ABL9_WANT)
        for k, v in runs["kernels"]["launches"].items():
            got[k] += v
        grads = train_parity(torch, runs, f"{variant} step: ×4 {variant}, "
                             "kernels vs preset: plain")
        launches[variant] = got
        numbers[variant] = {"fp32_vs_plain_max_abs": err, "bf16_psnr_db": db,
                            "unclamped_share": unclamped, "request_ms": ms,
                            "step_ms": runs["kernels"]["secs"] * 1e3,
                            "grads": grads}
        log(f"[{variant}] ×4 YAML's net, batch 8, LQ {h}×{w} → SR "
            f"{4 * h}×{4 * w}: fp32 vs preset: plain max|Δ| {err:.3e} (tol "
            f"{X2_PLAIN_TOL:g}; {unclamped:.3f} of the values unclamped), "
            f"bf16 vs fp32 {db:.2f} dB (min {ABL9_BF16_FLOOR:g}); request ms "
            + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
            + f"; training step (batch 2, LQ {ABL9_TRAIN_LR[0]}²) "
            f"{runs['kernels']['secs'] * 1e3:.1f} ms; launches "
            + ", ".join(f"{k} {v}" for k, v in got.items() if v))
        del runs, outs
        torch.cuda.empty_cache()
        if not err <= X2_PLAIN_TOL:
            raise AssertionError(f"[{variant}] fp32 vs plain max|Δ| {err}")
        if not db >= ABL9_BF16_FLOOR:
            raise AssertionError(f"[{variant}] bf16 vs fp32 {db} dB")
    return launches, numbers


TF32_X8_LR = (128, 128)     # phase 5's flagship request


def _set_tf32(torch, on):
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def tf32_readings(torch):
    """Phase 9e (C6): PyTorch's default TF32 for fp32 convolutions against
    TF32 off, which the entry points now set. One ×8 fp32 request (phase
    5's flagship net, batch 8, LQ 128²) and one ×2 ``bf16c3`` request
    (phase 8's ×2 net, batch 8, LQ 512²) with TF32 on and with it off, each
    a warm-up then a timed request: ms, max |Δ| and PSNR against fp32
    ``preset: plain`` (TF32 off) on the same weights. Leaves TF32 off.
    Returns the readings."""
    from endosr_torch.models.f_depthcond import FModelDepthCond
    from endosr_torch.ops.masks import depth_masks

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(9)
    net2 = {k: v for k, v in _yaml_net(X2_YAML).items() if k != "remat_blocks"}
    for label, opt_of, lr_hw, precision in (
            ("x8 fp32", lambda p, **n: flagship_opt(p, **n), TF32_X8_LR,
             "fp32"),
            ("x2 bf16c3", lambda p, **n: _x2_opt(p, {**net2, **n}), X2_LR,
             "bf16c3")):
        h, w = lr_hw
        dep = torch.rand((8, h, w, 1), generator=gen, device="cuda")
        req = {"LQ": torch.rand((8, h, w, 3), generator=gen, device="cuda"),
               "Depth": dep,
               "DepthMaskList": depth_masks(dep[..., 0], True, 10)}
        _set_tf32(torch, False)
        plain = FModelDepthCond(opt_of("fp32", preset="plain"))
        sd = {k: v.clone() for k, v in plain.netG.state_dict().items()}
        parts = []
        for k in range(0, 8, X2_PLAIN_BATCH):
            plain.feed_data({key: x[k:k + X2_PLAIN_BATCH]
                             for key, x in req.items()})
            parts.append(plain.test().clone())
        ref = torch.cat(parts)
        del plain, parts
        torch.cuda.empty_cache()
        m = FModelDepthCond(opt_of(precision))
        m.netG.load_state_dict(sd)
        rec = {}
        for tf32 in (True, False):
            _set_tf32(torch, tf32)
            m.feed_data(req)
            m.test()
            torch.cuda.synchronize()
            t = time.perf_counter()
            m.feed_data(req)
            sr = m.test()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            rec["on" if tf32 else "off"] = {
                "ms": ms, "max_abs_vs_plain": float((sr - ref).abs().max()),
                "psnr_db": psnr(sr, ref),
                "psnr_unclamped_db": _psnr_unclamped(sr.cpu().numpy(),
                                                     ref.cpu().numpy())}
        _set_tf32(torch, False)
        del m, sr, ref
        torch.cuda.empty_cache()
        out[label] = rec
        log(f"[tf32] {label}, batch 8, LQ {h}×{w}, against fp32 preset: "
            f"plain (TF32 off): " + "; ".join(
                f"TF32 {k}: {r['ms']:.1f} ms, max|Δ| "
                f"{r['max_abs_vs_plain']:.3e}, {r['psnr_db']:.2f} dB "
                f"(unclamped {r['psnr_unclamped_db'][0]:.2f} dB over "
                f"{r['psnr_unclamped_db'][1]:.3f})" for k, r in rec.items())
            + f"; {gpu_line()}")
    return out


class KernelTap:
    """While installed, records every launch of ``style_blend_dot``,
    ``style_dot_hwbm``, ``output_stage``, ``output_stage_x8``,
    ``packed_g123`` and ``head_dot``:
    ``calls`` maps (kernel, storage type, route, shape, extra) as
    :func:`kernel_call_check` takes them to {"grad": whether an input
    required a gradient, "where": {``self.where``: launches}}."""

    def __init__(self):
        self.calls, self.where = {}, None

    def install(self):
        from endosr_torch.kernels import head_dot as hd
        from endosr_torch.kernels import output_stage as ost
        from endosr_torch.kernels import packed_chain as pc
        from endosr_torch.kernels import style_dot as sd

        def dts(*ts):
            return tuple(str(t.dtype)[6:] for t in ts)

        taps = (
            (sd, "_blend", sd.style_blend_dot,
             lambda s, v, convs, bias, hwbc=False: (
                 tuple(s.shape) + (v.shape[2],), (convs[0].shape[3],),
                 (s, v, *convs, bias))),
            (sd, "_dot", sd.style_dot_hwbm,
             lambda s, v: (tuple(s.shape) + (v.shape[2],), (), (s, v))),
            (ost, "_forward", ost.output_stage,
             lambda p, r, lo, hi: (tuple(p.shape), (r, lo, hi), (p,))),
            (ost, "_forward_x8", ost.output_stage_x8,
             lambda p, lo, hi, order: (tuple(p.shape), (order, lo, hi), (p,))),
            (pc, "_forward", pc.packed_g123,
             lambda x, k1, b1, k2, b2, k3, b3, pre_act, pb, phases, k4=None,
             b4=None: (
                 tuple(x.shape) + tuple(k1.shape[2:]),
                 (pre_act, phases, dts(k1, b1, *(() if pb is None else (pb,)))),
                 (x, k1, b1, k2, b2, k3, b3) + (() if pb is None else (pb,)))),
            (hd, "_forward", hd.head_dot,
             lambda g4, w, b, wout, pb: (
                 tuple(g4.shape) + (w.shape[3],),
                 (wout, dts(w, b, *(() if pb is None else (pb,)))),
                 (g4, w, b) + (() if pb is None else (pb,)))))
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr, *_ in taps]
        for (mod, attr, counter, describe), (*_, orig) in zip(taps, saved):
            def tapped(*args, orig=orig, counter=counter, describe=describe):
                before = dict(counter.routes)
                out = orig(*args)
                shape, extra, tensors = describe(*args)
                route = next(k for k, n in counter.routes.items()
                             if n != before[k])
                rec = self.calls.setdefault(
                    (counter.__name__, str(tensors[0].dtype)[6:], route,
                     shape, extra), {"grad": False, "where": {}})
                rec["grad"] |= any(t.requires_grad for t in tensors)
                rec["where"][self.where] = rec["where"].get(self.where, 0) + 1
                return out

            setattr(mod, attr, tapped)

        def uninstall():
            for mod, attr, orig in saved:
                setattr(mod, attr, orig)

        return uninstall


def phase9_kernel_checks(torch, calls, tag="phase 9 kernels", controls=True):
    """Phase 9f: every kernel call that phase 9's paths (9a–9d) made, as
    :class:`KernelTap` recorded it, on the card at its shape, type, route
    and clamp by :func:`kernel_call_check`, its gradient too where the
    path took one. Then the checks' control: with each of
    ``vjp_controls``' wrong backwards in place, the gradient check of the
    smallest fp32 ``style_blend_dot`` call must fail (without
    ``controls``, not run). ``tag`` heads the log lines. Returns ({kernel:
    {type: max |Δ|}}, readings)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    errs, numbers = {}, {}
    for key in sorted(calls, key=str):
        name, dts, route, shape, extra = key
        grad = calls[key]["grad"]
        out, fails = kernel_call_check(torch, gen, name, getattr(torch, dts),
                                       route, shape, extra, grad)
        torch.cuda.empty_cache()
        what = (f"{name} {dts} {list(shape)} {extra} route {route}"
                f"{' + gradient' if grad else ''}")
        log(f"[{tag}] {what} (launches "
            + ", ".join(f"{k} {n}" for k, n in calls[key]["where"].items())
            + f"): max|Δ| {out['max_abs']:.3e}"
            + (f", rel {out['rel']:.3e}" if "rel" in out else
               " (bit-identical)")
            + (f"; gradient max |Δ| / max |ref| {out['grad_rel']:.3e}"
               if grad else "") + " against the plain version")
        if fails:
            raise AssertionError(f"[{tag}] {what}: "
                                 + "; ".join(fails))
        numbers[str(key)] = out
        slot = errs.setdefault(name, {})
        slot[dts] = max(slot.get(dts, 0.0), out["max_abs"])
    blends = [k for k in calls if k[0] == "style_blend_dot"
              and k[1] == "float32" and calls[k]["grad"] and controls]
    if blends:
        key = min(blends, key=lambda k: math.prod(k[3]))
        for label, vjp in vjp_controls(torch).items():
            with vjp_swapped(vjp):
                out, fails = kernel_call_check(
                    torch, gen, key[0], getattr(torch, key[1]), key[2], key[3],
                    key[4], True)
            numbers[f"control: {label}"] = out
            log(f"[phase 9 kernels] control, style_blend_dot backward "
                f"{label} at {list(key[3])}: gradient max |Δ| / max |ref| "
                f"{out['grad_rel']:.3e}: "
                + ("rejected" if fails else "accepted"))
            if not fails:
                raise AssertionError(f"[phase 9 kernels] the gradient check "
                                     f"accepts a {label} style_blend_dot "
                                     "backward")
    return errs, numbers


def phase9(torch, counters):
    """Phase 9: training at ×2, ×3 and ×4 from every shipped YAML,
    ``remat_blocks``, the ablations and TF32 (9a–9e), and the kernel
    calls of 9a–9d against their plain versions (9f). Returns ({path
    label: launches}, readings)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches, numbers = {}, {}
    tap = KernelTap()
    uninstall = tap.install()
    try:
        for key, phase in (("train", train_yamls),
                           ("remat_grads", remat_and_gradients),
                           ("ablations", ablations)):
            tap.where = key
            t = time.perf_counter()
            got, numbers[key] = phase(torch, counters)
            launches.update(got)
            numbers[key + "_s"] = time.perf_counter() - t
            log(f"[phase 9] {key}: {numbers[key + '_s']:.1f} s")
    finally:
        uninstall()
    t = time.perf_counter()
    numbers["tf32"] = tf32_readings(torch)
    numbers["tf32_s"] = time.perf_counter() - t
    t = time.perf_counter()
    numbers["kernel_max_abs_err"], numbers["kernels"] = phase9_kernel_checks(
        torch, tap.calls)
    numbers["kernels_s"] = time.perf_counter() - t
    log(f"[phase 9] kernel calls: {numbers['kernels_s']:.1f} s")
    numbers["seconds"] = time.perf_counter() - t0
    log(f"[phase 9] took {numbers['seconds']:.1f} s")
    return launches, numbers


DEPTH10_ROOT = "build/depth10"  # under the repository root, git-ignored
DEPTH10_FEED = (256, 320)       # endosr/depth/options.py:39-40 (height, width)
DEPTH10_N = 16                  # LR frames of 128² (Kvasir ×8: GT 1024²)
DEPTH10_TOL = 1e-4              # card vs CPU disparities, of max |ref|
X8_WANT = {"packed_g123": 2, "style_blend_dot": 2, "head_dot": 1,
           "output_stage_x8": 1}
X8_ROUTES = {"bf16": {"packed_g123": "wgmma", "style_blend_dot": "tc",
                      "head_dot": "wgmma", "output_stage_x8": "vec16"},
             "fp32": {"packed_g123": "fp32", "style_blend_dot": "cuda_core",
                      "head_dot": "fp32", "output_stage_x8": "vec16"}}
PIPE10_BF16_FLOOR = 40.0        # dB, bf16 against fp32 plain (§2)
PIPE10_FP32_TOL = 2e-4          # fp32 against fp32 plain: the parity bar
TRAIN10_STEPS = 3


class PipeTaps(EntryTaps):
    """:class:`EntryTaps` that also keeps each served batch (the host
    tensors ``test`` was fed) with its record, and the last model."""

    def _call(self, label, model, fn, args, kwargs, training=False):
        self.model = model
        batch = None if training else dict(model.batch)
        out = super()._call(label, model, fn, args, kwargs, training)
        if batch is not None:
            self.calls[label][-1]["batch"] = batch
        return out


def depth_producer(torch, root):
    """Phase 10a: ``depth/infer.py::run_folder`` on the card over the 16
    LR frames (seeded ResNet-18 ``encoder.pth`` / ``depth.pth`` at feed
    256×320 under ``root``): the ``.npy`` names, shape [1, 1, 256, 320]
    and type, and the disparities within ``DEPTH10_TOL`` of max |ref| of
    the port's CPU fp32 run on the same files. Twice on the card (the
    first run loads cuDNN's kernels). Returns the readings."""
    import numpy as np

    from endosr_torch.depth.infer import run_folder

    frames = root / "data/LR/train"
    secs = []
    for run in ("card", "card2"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        card = run_folder(str(frames), str(root), str(root / run))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    t = time.perf_counter()
    cpu = run_folder(str(frames), str(root), str(root / "cpu"), device="cpu")
    cpu_s = time.perf_counter() - t
    names = [f"f{i:02d}_disp.npy" for i in range(DEPTH10_N)]
    if [Path(p).name for p in card] != names or \
            [Path(p).name for p in cpu] != names:
        raise AssertionError(f"[depth10 producer] wrote {card}")
    err = ref_max = 0.0
    for a, b in zip(card, cpu):
        got, want = np.load(a), np.load(b)
        if got.shape != (1, 1, *DEPTH10_FEED) or got.dtype != np.float32:
            raise AssertionError(f"[depth10 producer] {a}: {got.shape} "
                                 f"{got.dtype}")
        if not (root / "card" / (Path(a).stem + ".jpeg")).is_file():
            raise AssertionError(f"[depth10 producer] no preview for {a}")
        err = max(err, float(np.abs(got - want).max()))
        ref_max = max(ref_max, float(np.abs(want).max()))
    out = {"ms_per_frame": [s / DEPTH10_N * 1e3 for s in secs],
           "cpu_ms_per_frame": cpu_s / DEPTH10_N * 1e3,
           "max_abs_vs_cpu": err, "rel_vs_cpu": err / ref_max}
    log(f"[depth10 producer] run_folder, 16 frames 128² → {DEPTH10_N} "
        f"disparities [1,1,{DEPTH10_FEED[0]},{DEPTH10_FEED[1]}] float32 + "
        f"previews: " + " / ".join(f"{x:.2f}" for x in out["ms_per_frame"])
        + f" ms a frame on the card (first / second run, loading the "
        f"weights and writing the files included), {out['cpu_ms_per_frame']:.1f} "
        f"on the CPU; card vs CPU max |Δ| {err:.3g} ({out['rel_vs_cpu']:.3g} "
        f"of max |ref|, tol {DEPTH10_TOL:g}); {gpu_line()}")
    if not out["rel_vs_cpu"] <= DEPTH10_TOL:
        raise AssertionError(f"[depth10 producer] card vs CPU "
                             f"{out['rel_vs_cpu']:.3g} > {DEPTH10_TOL:g}")
    return out


def _centred_generator(torch, root, argv):
    """A seeded flagship generator (``sr_pipeline.build_model``'s init) with
    its output conv scaled and shifted so that the fp32 output of the first
    batch of the pipeline's frames (the clamp opened) has its median at 0.5
    and its 1st–99th percentiles within [0.1, 0.9], as phase 7 centres
    its checkpoint; written to ``root/G.pth``."""
    import numpy as np

    from endosr_torch.data import util as dutil
    from endosr_torch.ops.masks import depth_masks_np
    from endosr_torch.tools import sr_pipeline as pipe

    args = pipe.parse_args(argv)
    model = pipe.build_model(args, "cuda")
    model.netG.clamp_min, model.netG.clamp_max = -1e4, 1e4
    names = dutil.get_image_paths("img", args.input)[:8]
    deps = [np.load(root / "card" / (Path(n).stem + "_disp.npy"))[0, 0]
            for n in names]
    model.feed_data({
        "LQ": np.stack([dutil.read_img(None, n)[:, :, ::-1] for n in names]
                       ).astype(np.float32),
        "Depth": np.stack(deps)[..., None],
        "DepthMaskList": np.stack([depth_masks_np(d, True, 10)
                                   for d in deps])})
    outs = model.test().float().reshape(-1, 3).cpu().numpy()
    lo, med, hi = np.percentile(outs, [1, 50, 99], axis=0)
    half = float(np.max(np.maximum(med - lo, hi - med)))
    scale = min(1.0, 0.4 / half) if half > 0 else 1.0
    sd = {k: v.detach().cpu() for k, v in model.netG.state_dict().items()}
    del model
    shift = torch.as_tensor(0.5 - scale * med, dtype=torch.float32)
    sd["conv_output.weight"] = sd["conv_output.weight"] * scale
    sd["conv_output.bias"] = sd["conv_output.bias"] * scale + shift
    torch.save(sd, str(root / "G.pth"))
    return scale, shift.tolist()


def pipeline10(torch, counters, root):
    """Phase 10b: ``python -m endosr_torch.tools.sr_pipeline`` through
    ``main`` on the 16 frames with ``--depth_weights`` (the producer, then
    masks, then ``FModelDepthCond.test`` in batches of 8), the flagship ×8
    at its defaults (nf 64, nb 16, latent 256, blocks 0–13, K 10), ``--bucket
    0``, a seeded ``G.pth`` centred as phase 7 centres its checkpoint;
    ``--precision bf16``, then fp32. Each ``test`` with the counts set to
    0 just before and read just after: ``X8_WANT`` on ``X8_ROUTES``. The
    SR of each batch against fp32 ``preset: plain`` (no kernel) on the
    same inputs: bf16 ≥ ``PIPE10_BF16_FLOOR`` dB, fp32 within
    ``PIPE10_FP32_TOL``. ms a frame by stage (depth maps, model build,
    serving, the rest: reading frames, masks, PNGs) and end to end.
    Returns ({path label: launches}, readings)."""
    import numpy as np

    import cv2

    from endosr_torch.models.f_depthcond import FModelDepthCond
    from endosr_torch.tools import sr_pipeline as pipe

    base = ["--input", str(root / "data/LR/train"), "--model",
            str(root / "G.pth"), "--scale", "8", "--bucket", "0",
            "--batch", "8", "--depth_weights", str(root)]
    scale, shift = _centred_generator(
        torch, root, base[:2] + ["--output", str(root / "unused"),
                                 "--model", "", "--scale", "8"])
    log(f"[pipeline10] G.pth: seeded flagship, conv_output × {scale:.4g} + "
        f"{[round(x, 4) for x in shift]}")
    stage = {}

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stage[name] = time.perf_counter() - t
            return out
        return wrapper

    taps = PipeTaps(torch, counters)
    launches, numbers, runs = {}, {}, {}
    saved = pipe.ensure_depth, pipe.build_model
    uninstall = taps.install()
    try:
        pipe.ensure_depth = timed("depth", pipe.ensure_depth)
        pipe.build_model = timed("build", pipe.build_model)
        for prec in ("bf16", "fp32"):
            label = f"x8 pipeline {prec}"
            taps.serving = label
            out = root / f"pipe_{prec}"
            argv = base + ["--output", str(out)] + (
                ["--precision", "bf16"] if prec == "bf16" else [])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            written = pipe.main(argv)
            torch.cuda.synchronize()
            total = time.perf_counter() - t
            calls = taps.calls[label]
            taps.check(label, calls, X8_WANT, X8_ROUTES[prec])
            if sorted(written) != [f"f{i:02d}" for i in range(DEPTH10_N)]:
                raise AssertionError(f"[{label}] wrote {sorted(written)}")
            png = cv2.imread(written["f00"])
            if png.shape != (1024, 1024, 3):
                raise AssertionError(f"[{label}] PNG {png.shape}")
            serve = sum(r["secs"] for r in calls)
            ms = {"depth": stage["depth"], "build": stage["build"],
                  "serve": serve,
                  "rest": total - stage["depth"] - stage["build"] - serve,
                  "end_to_end": total}
            ms = {k: v / DEPTH10_N * 1e3 for k, v in ms.items()}
            ms["serve_batches"] = [r["secs"] * 1e3 for r in calls]
            ms["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            runs[prec], numbers[label] = calls, ms
            launches[label] = {c.__name__: sum(r["launches"][c.__name__]
                                               for r in calls)
                               for c in counters}
            log(f"[{label}] {len(calls)} batches of 8, LQ 128² → SR 1024², "
                + ", ".join(f"{k} {v}" for k, v in X8_WANT.items())
                + " launches a batch (" + ", ".join(
                    f"{k} {v}" for k, v in X8_ROUTES[prec].items())
                + "); ms a frame: depth maps {depth:.2f}, model {build:.2f}, "
                  "serving {serve:.2f}, reading/masks/PNGs {rest:.2f}, end "
                  "to end {end_to_end:.2f}; batch ms ".format(**ms)
                + ", ".join(f"{x:.1f}" for x in ms["serve_batches"])
                + f"; peak {ms['peak_gib']:.2f} GiB; {gpu_line()}")
    finally:
        pipe.ensure_depth, pipe.build_model = saved
        uninstall()
    opt = flagship_opt(None, 8, 0, preset="plain")
    opt["path"] = {"pretrain_model_G": str(root / "G.pth"), "strict_load": True}
    plain = FModelDepthCond(opt)
    zero_counts(counters)
    refs = []
    for rec in runs["fp32"]:
        plain.feed_data(rec["batch"])
        refs.append(plain.test().float().cpu())
    if any(c.launches for c in counters):
        raise AssertionError("[pipeline10] preset: plain launched a kernel")
    del plain
    torch.cuda.empty_cache()
    for prec, calls in runs.items():
        for n, (rec, ref) in enumerate(zip(calls, refs)):
            if not all(torch.equal(v, runs["fp32"][n]["batch"][k])
                       for k, v in rec["batch"].items()):
                raise AssertionError(f"[pipeline10] {prec} batch {n + 1} was "
                                     "fed other inputs than fp32's")
    reads = {}
    for prec, calls in runs.items():
        sr = torch.cat([r["sr"] for r in calls])
        ref = torch.cat(refs)
        d = (sr.double() - ref.double())
        mse = float(d.square().mean())
        db = 10 * math.log10(1 / mse) if mse > 0 else float("inf")
        db_u, share = _psnr_unclamped(sr.numpy(), ref.numpy())
        reads[prec] = {"max_abs": float(d.abs().max()), "psnr": db,
                       "psnr_unclamped": db_u, "unclamped_share": share}
        log(f"[x8 pipeline {prec}] against fp32 preset: plain on the same "
            f"inputs: max |Δ| {reads[prec]['max_abs']:.3g}, PSNR {db:.2f} dB "
            f"({db_u:.2f} over the {share:.3f} of values neither clamps)")
    numbers["vs_plain"] = reads
    if not reads["bf16"]["psnr"] >= PIPE10_BF16_FLOOR:
        raise AssertionError(f"[pipeline10] bf16 {reads['bf16']['psnr']:.2f} "
                             f"dB < {PIPE10_BF16_FLOOR}")
    if not reads["fp32"]["max_abs"] <= PIPE10_FP32_TOL:
        raise AssertionError(f"[pipeline10] fp32 max |Δ| "
                             f"{reads['fp32']['max_abs']:.3g} > "
                             f"{PIPE10_FP32_TOL:g}")
    return launches, numbers


def _with_losses(opt, root):
    """``opt`` with the depth loss (``pretrained_model_path``: ``root``)
    and the VGG loss (``root/vgg19.pth``) turned on."""
    opt["train"] = copy.deepcopy(opt["train"])
    opt["train"]["depth_loss"].update(use_depth_criterion=True,
                                      pretrained_model_path=str(root))
    opt["train"]["vgg_loss"].update(use_vgg_criterion=True,
                                    vgg_weights_path=str(root / "vgg19.pth"))
    return opt


def _frozen_unchanged(torch, model, root):
    """The depth and VGG networks of ``model`` equal their files, take no
    gradient, are in ``eval()`` and in no optimizer group."""
    from endosr_torch.utils.port_params import load_monodepth

    enc, dec, _, _ = load_monodepth(str(root))
    vgg = torch.load(str(root / "vgg19.pth"), weights_only=True)
    pairs = ((model.depth_loss_fn.encoder, enc.state_dict()),
             (model.depth_loss_fn.decoder, dec.state_dict()),
             (model.vgg_loss_fn.model, vgg))
    in_opt = {id(p) for g in model.optimizer_G.param_groups
              for p in g["params"]}
    for net, want in pairs:
        for k, v in net.state_dict().items():
            if not torch.equal(v.cpu(), want[k]):
                raise AssertionError(f"[train10] frozen {k} changed")
        if net.training or any(p.requires_grad or id(p) in in_opt
                               for p in net.parameters()):
            raise AssertionError("[train10] a frozen network trains")


def train10(torch, counters, root):
    """Phase 10c: ``python -m endosr_torch.train`` through ``main`` on the
    ×8 YAML with phase 7's key changes (the data roots on the 16 pairs
    under ``root/data``, ``path.root``, ``data_num``, ``niter`` 3,
    ``val_freq`` 1000, ``save_checkpoint_freq`` 3, ``print_freq`` 1) and
    both losses on (``use_depth_criterion``, ``pretrained_model_path``:
    ``root``; ``use_vgg_criterion``, ``vgg_weights_path``), fp32 (TF32
    off), batch 8, GT 1024², 3 steps; each step with the counts set to 0
    just before and read just after (``X8_WANT`` on fp32 routes), every
    loss finite. Then one more step of that model as step 0 with the cwd
    under ``root/dump``: ``_dump_disparities`` writes its 8 arrays. The
    frozen networks unchanged after all (:func:`_frozen_unchanged`).
    Returns ({path label: launches}, readings)."""
    import gc
    import os

    import numpy as np

    import endosr_torch.train as entry_train
    from endosr_torch.ops.masks import depth_masks

    repo = Path(__file__).resolve().parent
    tree = {"dataroot_GT": str(root / "data/HR/train"),
            "dataroot_LQ": str(root / "data/LR/train"),
            "dataroot_depthMap": str(root / "data/depth/train")}
    changes = {f"datasets.{ph}.{k}": v for ph in ("train", "val")
               for k, v in tree.items()}
    changes.update({
        "datasets.train.data_num": DEPTH10_N, "path.root": str(root / "run"),
        "train.niter": TRAIN10_STEPS, "train.val_freq": 1000,
        "logger.save_checkpoint_freq": TRAIN10_STEPS, "logger.print_freq": 1,
        "train.depth_loss.use_depth_criterion": True,
        "train.depth_loss.pretrained_model_path": str(root),
        "train.vgg_loss.use_vgg_criterion": True,
        "train.vgg_loss.vgg_weights_path": str(root / "vgg19.pth")})
    yml = _derive(repo / "options/train/train_depthNet_SEAN_depthMask_x8.yml",
                  root / "train.yml", changes, "train10")
    label = "x8 train losses"
    taps = PipeTaps(torch, counters)
    taps.training = label
    uninstall = taps.install()
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        model = entry_train.main(["-opt_F", yml])
        main_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        calls = taps.calls[label]
        taps.check(label, calls, X8_WANT, X8_ROUTES["fp32"])
        keys = {"l_pix", "l_depth", "l_vgg", "l_all",
                *(f"l_{n}_{i}" for n in ("depth", "vgg") for i in range(4))}
        for n, rec in enumerate(calls):
            bad = [k for k in keys if not math.isfinite(rec["logs"].get(
                k, float("nan")))]
            if bad:
                raise AssertionError(f"[{label}] step {n + 1}: {bad} not "
                                     "finite or missing")
        if len(calls) != TRAIN10_STEPS:
            raise AssertionError(f"[{label}] {len(calls)} steps")
        # step 0: the disparity dump, then the step
        taps.training = label + " step 0"
        gen = torch.Generator(device="cuda").manual_seed(10)
        dep = torch.rand((8, 128, 128, 1), generator=gen, device="cuda")
        model.feed_data({
            "LQ": torch.randint(0, 256, (8, 128, 128, 3), generator=gen,
                                device="cuda", dtype=torch.uint8),
            "GT": torch.randint(0, 256, (8, 1024, 1024, 3), generator=gen,
                                device="cuda", dtype=torch.uint8),
            "Depth": dep,
            "DepthMaskList": depth_masks(dep[..., 0], False, 10).to(
                torch.uint8)})
        cwd = os.getcwd()
        (root / "dump").mkdir()
        os.chdir(root / "dump")
        try:
            model.optimize_parameters(0)
        finally:
            os.chdir(cwd)
        taps.check(label + " step 0", taps.calls[label + " step 0"],
                   {k: 2 * v for k, v in X8_WANT.items()}, X8_ROUTES["fp32"])
        dumped = sorted(os.listdir(root / "dump/tmp"))
        if dumped != sorted(f"{t}_{i}.npy" for t in ("hr", "sr")
                            for i in range(4)):
            raise AssertionError(f"[{label}] dumped {dumped}")
        for t in ("sr", "hr"):
            for i in range(4):
                a = np.load(root / f"dump/tmp/{t}_{i}.npy")
                want = (8, DEPTH10_FEED[0] >> i, DEPTH10_FEED[1] >> i, 1)
                if a.shape != want or not np.isfinite(a).all():
                    raise AssertionError(f"[{label}] {t}_{i}.npy {a.shape}")
        _frozen_unchanged(torch, model, root)
        del model
    finally:
        uninstall()
    gc.collect()
    torch.cuda.empty_cache()
    ms = [r["secs"] * 1e3 for r in calls]
    logs = [{k: r["logs"][k] for k in sorted(keys)} for r in calls]
    numbers = {"ms": ms, "ms_per_step": sum(ms[1:]) / (len(ms) - 1),
               "peak_gib": peak, "main_s": main_s, "logs": logs,
               "step0_ms": taps.calls[label + " step 0"][0]["secs"] * 1e3}
    log(f"[{label}] train.main, ×8 YAML, fp32, batch 8, GT 1024², depth + "
        f"VGG losses: " + ", ".join(f"{k} {v}" for k, v in X8_WANT.items())
        + " launches a step (fp32 routes); step ms " + ", ".join(
            f"{x:.1f}" for x in ms) + f" ({numbers['ms_per_step']:.1f} a step "
        f"after the first, host clock, synchronised); peak {peak:.2f} GiB; "
        f"step 0 with the dump {numbers['step0_ms']:.1f} ms, 8 arrays "
        f"written; frozen networks unchanged; logs step 1 {logs[0]}; "
        f"{main_s:.1f} s in main; {gpu_line()}")
    launches = {lab: {c.__name__: sum(r["launches"][c.__name__]
                                      for r in taps.calls[lab])
                      for c in counters}
                for lab in (label, label + " step 0")}
    return launches, numbers


def grads10(torch, counters, root):
    """Phase 10d: one fp32 batch-2 step of 10c's recipe (the ×8 recipe
    with both losses on, LQ 128² → GT 1024²) against the same step under
    ``preset: plain`` by phase 6b's rule (``parity_runs``,
    ``train_parity``). Returns ({path label: launches}, readings)."""
    from endosr_torch.models.recipes import x8_train_opt

    runs = parity_runs(
        torch, opt_of=lambda **net: _with_losses(
            x8_train_opt("fp32", **net), root),
        batch=parity_batch(torch, 8, (128, 128)), counters=counters)
    k = runs["kernels"]
    for name in k["launches"]:
        if k["launches"][name] != X8_WANT.get(name, 0):
            raise AssertionError(f"[grads10] {name}: {k['launches'][name]} "
                                 "launches")
    if any(runs["plain"]["launches"].values()):
        raise AssertionError("[grads10] preset: plain launched a kernel")
    readings = train_parity(torch, runs, "x8 losses parity: default vs "
                            "preset: plain, depth + VGG losses on")
    readings.update(step_ms=k["secs"] * 1e3, peak_gib=k["peak_gib"],
                    logs=k["logs"])
    return {"x8 losses grads": dict(k["launches"])}, readings


def phase10(torch, counters):
    """Phase 10: frames → depth maps → SR on the card and the ×8 training
    step with the depth and VGG losses (10a–10d), then every kernel call
    of 10b–10d, recorded by :class:`KernelTap`, again at its shape against
    its plain version, forward and gradient (10e,
    ``phase9_kernel_checks`` without its controls). Seeded weight files
    (a ResNet-18 ``encoder.pth`` at feed 256×320, ``depth.pth``,
    ``vgg19.pth``) and a synthetic Kvasir tree (16 pairs, LR 128², GT
    1024²) are written under ``DEPTH10_ROOT``. Returns ({path label:
    launches}, readings)."""
    import gc
    import shutil

    from endosr_torch.utils.port_params import (write_seeded_monodepth,
                                                write_seeded_vgg)

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent / DEPTH10_ROOT
    shutil.rmtree(root, ignore_errors=True)
    write_seeded_monodepth(str(root), seed=10, height=DEPTH10_FEED[0],
                           width=DEPTH10_FEED[1])
    write_seeded_vgg(str(root / "vgg19.pth"), seed=11)
    write_kvasir(root / "data", 8, {"train": (128, 128)},
                 {"train": DEPTH10_N})
    numbers = {"setup_s": time.perf_counter() - t0}
    launches = {}
    t = time.perf_counter()
    numbers["producer"] = depth_producer(torch, root)
    numbers["producer_s"] = time.perf_counter() - t
    tap = KernelTap()
    uninstall = tap.install()
    try:
        for key, fn in (("pipeline", pipeline10), ("train", train10),
                        ("grads", grads10)):
            tap.where = key
            t = time.perf_counter()
            got, numbers[key] = fn(torch, counters, root)
            launches.update(got)
            numbers[key + "_s"] = time.perf_counter() - t
            log(f"[phase 10] {key}: {numbers[key + '_s']:.1f} s")
    finally:
        uninstall()
    t = time.perf_counter()
    numbers["kernel_max_abs_err"], numbers["kernels"] = phase9_kernel_checks(
        torch, tap.calls, "phase 10 kernels", controls=False)
    numbers["kernels_s"] = time.perf_counter() - t
    numbers["seconds"] = time.perf_counter() - t0
    log(f"[phase 10] kernel calls: {numbers['kernels_s']:.1f} s; took "
        f"{numbers['seconds']:.1f} s")
    return launches, numbers


DEPTH11_ROOT = "build/depth11"  # under the repository root, git-ignored
DEPTH11_N = 62                  # frames of the synthetic sequence
DEPTH11_HW = (320, 400)         # frame size on disk (the feed's 1.25 ratio)
DEPTH11_FEED = (256, 320)       # endosr/depth/options.py:39-40 (height, width)
DEPTH11_STEREO_N = 14           # frames a camera of the stereo layout
DEPTH11_LOSS_REL = 1e-5         # card vs CPU losses, relative
DEPTH11_LOADER_PASSES = 3       # epochs of 11a's loader-alone reading
DEPTH11_VARIANTS = {            # phase 11b: extra options, stereo dataset
    "posecnn": (["--pose_model_type", "posecnn"], None),
    "stereo": (["--use_stereo"], [0, -1, 1, "s"]),
    "stereo_only": (["--use_stereo", "--frame_ids", "0"], [0, "s"]),
    "v1_multiscale": (["--v1_multiscale"], None),
    "avg_reprojection": (["--avg_reprojection"], None),
    "disable_automasking": (["--disable_automasking"], None),
    "no_ssim": (["--no_ssim"], None),
    "resnet50": (["--num_layers", "50"], None),
}


def write_depth11(root):
    """Phase 11's data under ``root``: ``frames/`` (``DEPTH11_N`` frames
    of a smooth shaded image with blurred noise as texture, panned 3 px
    and zoomed 0.4 % a frame, so that the photometric loss has signal) and ``endovis/seq/`` (the
    stereo layout ``image01`` / ``image02``, the right camera 6 px over,
    single-camera frames and GT depth PNGs in [5, 70])."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(11)
    h, w = DEPTH11_HW
    base = _smooth_u8(np, rng, h + 96, w + 256).astype(np.float32)
    # texture at a few pixels' scale over the smooth shading
    base += cv2.GaussianBlur(rng.normal(0, 60, base.shape).astype(np.float32),
                             (0, 0), 1.5)
    base = np.clip(base, 0, 255).astype(np.uint8)

    def frame(i, dx=0):
        s = 1.0 + 0.004 * i
        m = np.float32([[s, 0, (1 - s) * (w / 2) + 3 * i + dx + 48],
                        [0, s, (1 - s) * (h / 2) + 48]])
        return cv2.warpAffine(base, m, (w, h), flags=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_REFLECT)

    (root / "frames").mkdir(parents=True)
    for i in range(DEPTH11_N):
        cv2.imwrite(str(root / f"frames/{i:010d}.jpg"), frame(i))
    seq = root / "endovis/seq"
    for sub in ("image01", "image02", "depth"):
        (seq / sub).mkdir(parents=True)
    for i in range(DEPTH11_STEREO_N):
        cv2.imwrite(str(seq / f"image01/{i:010d}.jpg"), frame(i))
        cv2.imwrite(str(seq / f"image02/{i:010d}.jpg"), frame(i, 6))
        cv2.imwrite(str(seq / f"{i:010d}.jpg"), frame(i))
        depth = 5 + 65 * rng.random((h // 8, w // 8))
        cv2.imwrite(str(seq / f"depth/{i:010d}.png"), cv2.resize(
            depth, (w, h), interpolation=cv2.INTER_LINEAR).astype(np.uint16))


def _depth11_argv(root, *extra):
    return ["--data_path", str(root / "frames"), "--log_dir",
            str(root / "logs"), *extra]


def _finite_losses(label, losses):
    bad = [k for k, v in losses.items() if not math.isfinite(float(v))]
    if bad or "loss" not in losses:
        raise AssertionError(f"[{label}] losses {bad} not finite or missing")


def depth11_train(torch, root):
    """Phase 11a: ``python -m endosr_torch.depth.train`` through ``main``
    at the endovis defaults (feed 256×320, batch 12, ResNet-18,
    ``separate_resnet``, frames [0, -1, 1], scales 0–3, Adam 1e-4, 4
    loader workers) on the 62 frames, one epoch (5 steps), each step timed
    on the host clock between two synchronisations, every loss finite;
    peak memory; then the trainer's loader alone over
    ``DEPTH11_LOADER_PASSES`` more epochs, its workers started (items and
    frames a second), and the time of an item made in this process.
    Returns (trainer, readings)."""
    import endosr_torch.depth.train as depth_train
    from endosr_torch.depth import trainer as tmod

    argv = _depth11_argv(root, "--num_epochs", "1", "--log_frequency", "1")
    reduced = {"num_epochs": "20 → 1", "log_frequency": "250 → 1",
               "data": f"{DEPTH11_N} synthetic frames "
               f"{DEPTH11_HW[0]}×{DEPTH11_HW[1]} → 60 items, 5 steps"}
    log(f"[depth11 train] reduced: {json.dumps(reduced)}")
    steps, marks = [], []
    train_step = tmod.Trainer.train_step

    def timed(self, inputs, noise=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = train_step(self, inputs, noise)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t,
                      {k: float(v) for k, v in out.items()}))
        marks.append((t, time.perf_counter()))
        return out

    tmod.Trainer.train_step = timed
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = depth_train.main(argv)
        main_s = time.perf_counter() - t0
    finally:
        tmod.Trainer.train_step = train_step
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if tr.step < 5 or len(steps) != tr.step:
        raise AssertionError(f"[depth11 train] {tr.step} steps")
    for n, (_, losses) in enumerate(steps):
        _finite_losses(f"depth11 train step {n + 1}", losses)
    ms = [s * 1e3 for s, _ in steps]
    waits = [(b[0] - a[1]) * 1e3 for a, b in zip(marks, marks[1:])]
    bs = tr.opt.batch_size
    t = time.perf_counter()
    first, n = None, 0
    for _ in range(DEPTH11_LOADER_PASSES):
        for batch in tr.loader():
            n += batch[("color", 0, 0)].shape[0]
            first = first or time.perf_counter()
    end = time.perf_counter()
    t_item = time.perf_counter()
    for i in range(bs):
        tr.dataset[i]
    item_ms = (time.perf_counter() - t_item) / bs * 1e3
    steady = sorted(ms[2:])[len(ms[2:]) // 2]
    out = {"reduced": reduced, "steps": tr.step, "ms": ms,
           "first_ms": ms[0], "ms_per_step": sum(ms[1:]) / (len(ms) - 1),
           "steady_ms": steady, "waits_ms": waits, "peak_gib": peak,
           "main_s": main_s, "loader_items": n,
           "loader_items_per_s": n / (end - t),
           "loader_items_per_s_after_first": (n - bs) / max(end - first, 1e-9),
           "loader_first_batch_s": first - t, "item_ms_in_process": item_ms,
           "losses": [lo["loss"] for _, lo in steps]}
    out["step_items_per_s"] = bs / (steady / 1e3)
    log(f"[depth11 train] depth.train.main, endovis defaults (feed 256×320, "
        f"batch {bs}, ResNet-18, separate_resnet, frames [0, -1, 1], scales "
        f"0–3), fp32 with TF32 off: {tr.step} steps, ms "
        + ", ".join(f"{x:.1f}" for x in ms)
        + f" ({out['ms_per_step']:.1f} a step after the first, median of "
        f"steps 3–{tr.step} {steady:.1f}, host clock, synchronised; between "
        f"steps "
        + ", ".join(f"{x:.1f}" for x in waits) + " ms); peak "
        f"{peak:.2f} GiB; losses " + ", ".join(f"{x:.4f}" for x in
                                                out["losses"])
        + f"; loader alone, its {tr.opt.num_workers} spawned workers started, "
        f"{DEPTH11_LOADER_PASSES} epochs ({n} items): "
        f"{out['loader_items_per_s']:.1f} items/s ({3 * out['loader_items_per_s']:.1f}"
        f" frames/s; first batch after {out['loader_first_batch_s']:.2f} s, "
        f"then {out['loader_items_per_s_after_first']:.1f} items/s) against "
        f"the steps' {out['step_items_per_s']:.1f} (median step); an item "
        f"made in this process {item_ms:.1f} ms; {main_s:.1f} s in main; "
        f"{gpu_line()}")
    return tr, out


def _depth11_dataset(root, opts, frame_ids):
    """The 12 items of a variant step: the sequence folder's frames, or the
    stereo layout's (``l`` / ``r`` sides in turn) for ``frame_ids``."""
    from endosr_torch.depth.datasets import EndovisDataset
    from endosr_torch.depth.train import build_dataset

    if frame_ids is None:
        return build_dataset(opts)
    lines = [f"seq {i} {'lr'[i % 2]}" for i in range(1, DEPTH11_STEREO_N - 1)]
    return EndovisDataset(str(root / "endovis"), lines[:opts.batch_size],
                          opts.height, opts.width, frame_ids,
                          num_scales=len(opts.scales), is_train=True)


def depth11_variants(torch, root):
    """Phase 11b: one full-width step (feed 256×320, batch 12) of each of
    ``DEPTH11_VARIANTS`` after one warm-up step: every loss finite, ms of
    the step. Returns {variant: readings}."""
    import gc

    from endosr_torch.depth.options import MonodepthOptions
    from endosr_torch.depth.trainer import Trainer

    out = {}
    for name, (extra, frame_ids) in DEPTH11_VARIANTS.items():
        opts = MonodepthOptions().parse(_depth11_argv(
            root, "--num_workers", "0", *extra))
        tr = Trainer(opts, dataset=_depth11_dataset(root, opts, frame_ids),
                     seed=12)
        batch = tr.to_device(next(iter(tr.loader())))
        secs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses = tr.train_step(batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            _finite_losses(f"depth11 {name}", losses)
        out[name] = {"ms": secs[1] * 1e3, "first_ms": secs[0] * 1e3,
                     "loss": float(losses["loss"]),
                     "frame_ids": tr.frame_ids, "pose_net": tr.use_pose_net}
        del tr, batch
        gc.collect()
        torch.cuda.empty_cache()
    log("[depth11 variants] one step each, feed 256×320, batch 12, fp32: "
        + "; ".join(f"{k} {v['ms']:.1f} ms (first {v['first_ms']:.1f}, "
                    f"loss {v['loss']:.4f}, frames {v['frame_ids']})"
                    for k, v in out.items()) + f"; {gpu_line()}")
    if out["stereo_only"]["pose_net"] or out["stereo"]["frame_ids"][-1] != "s":
        raise AssertionError("[depth11 variants] stereo frames or pose nets")
    return out


def _depth11_grads(torch, tr, weights, batch, noise_seed=5):
    """The loss and gradients of one fp32 step of ``tr``'s networks from
    ``weights`` (CPU tensors by ``models.name.key``) on the CPU batch
    ``batch``, the noise drawn on the CPU (seed ``noise_seed``) and moved
    to the trainer's device. cuDNN takes its deterministic algorithms."""
    from endosr_torch.depth.trainer import monodepth_loss

    cudnn = torch.backends.cudnn
    was = cudnn.deterministic
    cudnn.deterministic = True
    gen = torch.Generator().manual_seed(noise_seed)
    try:
        named = {f"{n}.{k}": p for n, m in tr.models.items()
                 for k, p in m.named_parameters()}
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(weights[k])
        tr.set_train()
        for p in named.values():
            p.grad = None
        total, losses, _ = monodepth_loss(
            tr.models, tr.to_device(batch), tr.loss_opt(),
            lambda shape: torch.randn(shape, generator=gen).to(tr.device))
        total.backward()
        return ({k: v.item() for k, v in losses.items()},
                {k: p.grad.detach().cpu().clone() for k, p in named.items()})
    finally:
        cudnn.deterministic = was


def depth11_parity(torch, root):
    """Phase 11c: one fp32 step (loss and gradients) at feed 256×320,
    batch 2, on the card against the port on the CPU: the same weights,
    batch and noise. Losses within ``DEPTH11_LOSS_REL``; each gradient by
    phase 6b's rule (its norm-relative distance within ``GRAD_NOISE`` ×
    the largest change of either side's own gradient under four one-ulp
    nudges (every image up, every image down, every weight up or down at
    random, twice) + ``GRAD_FLOOR``; all gradients as one vector within
    the larger of ``GRAD_NREL_ALL`` and ``GRAD_NOISE``× the nudges' change
    of it). The card's step runs twice and both readings must pass.
    Returns the readings."""
    import random

    from endosr_torch.data import collate
    from endosr_torch.depth.options import MonodepthOptions
    from endosr_torch.depth.trainer import Trainer

    argv = _depth11_argv(root, "--batch_size", "2", "--num_workers", "0")
    card = Trainer(MonodepthOptions().parse(argv), seed=13)
    cpu = Trainer(MonodepthOptions().parse(argv + ["--no_cuda"]), seed=13)
    if cpu.device.type != "cpu":
        raise AssertionError("[depth11 parity] the reference is not on the CPU")
    weights = {f"{n}.{k}": p.detach().cpu().clone()
               for n, m in cpu.models.items() for k, p in m.named_parameters()}
    for n, m in card.models.items():
        for k, p in m.named_parameters():
            if not torch.equal(p.detach().cpu(), weights[f"{n}.{k}"]):
                raise AssertionError(f"[depth11 parity] {n}.{k} starts apart")
    from endosr_torch.depth.train import build_dataset

    ds = build_dataset(card.opt)
    ds.rng = random.Random(3)
    batch = collate([ds[i] for i in (4, 31)])

    def images(to):
        return {k: (torch.nextafter(v, torch.full_like(v, to))
                    if isinstance(k, tuple) and k[0].startswith("color")
                    else v) for k, v in batch.items()}

    cases = {"images + 1 ulp": (weights, images(2.0)),
             "images - 1 ulp": (weights, images(-1.0)),
             "weights ± 1 ulp (a)": (_nudge_weights(torch, weights, 7, "cpu"),
                                     batch),
             "weights ± 1 ulp (b)": (_nudge_weights(torch, weights, 8, "cpu"),
                                     batch)}
    t = time.perf_counter()
    ref_logs, ref = _depth11_grads(torch, cpu, weights, batch)
    nudged = {"cpu " + k: _depth11_grads(torch, cpu, w, b)[1]
              for k, (w, b) in cases.items()}
    cpu_s = time.perf_counter() - t
    runs = [_depth11_grads(torch, card, weights, batch) for _ in range(2)]
    base = runs[0][1]
    nudged.update({"card " + k: _depth11_grads(torch, card, w, b)[1]
                   for k, (w, b) in cases.items()})

    def nrel(a, b):
        return float((a - b).norm()) / max(float(b.norm()), 1e-30)

    readings = []
    for r, (logs, grads) in enumerate(runs, start=1):
        fails, rows = [], []
        worst_log = max(abs(logs[k] - v) / max(abs(v), 1e-12)
                        for k, v in ref_logs.items())
        if sorted(logs) != sorted(ref_logs) or not worst_log <= DEPTH11_LOSS_REL:
            fails.append(f"losses {worst_log:.3g} relative")
        num = den = 0.0
        num_n = dict.fromkeys(nudged, 0.0)
        for k, g in ref.items():
            d = grads[k] - g
            num += float(d.square().sum())
            den += float(g.square().sum())
            noise = 0.0
            for lab, n in nudged.items():
                mine = ref if lab.startswith("cpu") else base
                num_n[lab] += float((n[k] - mine[k]).square().sum())
                noise = max(noise, nrel(n[k], mine[k]))
            err = nrel(grads[k], g)
            tol = GRAD_NOISE * noise + GRAD_FLOOR
            rows.append((err / tol, err, noise, k))
            if not err <= tol:
                fails.append(f"{k}: {err:.3g} > {tol:.3g}")
        rows.sort(reverse=True)
        nrel_all = (num / den) ** 0.5
        noise_all = max(v / den for v in num_n.values()) ** 0.5
        tol_all = max(GRAD_NREL_ALL, GRAD_NOISE * noise_all)
        if not nrel_all <= tol_all:
            fails.append(f"all gradients {nrel_all:.3g} > {tol_all:.3g}")
        reading = {"losses_rel": worst_log, "grad_nrel": nrel_all,
                   "grad_nrel_tol": tol_all, "grad_noise_all": noise_all,
                   "worst_of_tol": rows[0][0], "worst": rows[0][3],
                   "grad_nrel_worst": max(x[1] for x in rows)}
        log(f"[depth11 parity] card run {r} vs CPU, fp32, feed 256×320, "
            f"batch 2: losses ≤ {worst_log:.3g} relative (tol "
            f"{DEPTH11_LOSS_REL:g}); all gradients norm-relative "
            f"{nrel_all:.3g} (tol {tol_all:.3g}); per tensor nearest the "
            f"bound: " + ", ".join(f"{k} {e:.3g} (one-ulp {n:.3g}, "
                                    f"{q:.2f} of tol)"
                                    for q, e, n, k in rows[:5])
            + f" ({len(rows)} tensors)")
        if fails:
            raise AssertionError(f"[depth11 parity] card run {r}: "
                                 + "; ".join(fails[:12]))
        readings.append(reading)
    moved = max(float((runs[1][1][k] - base[k]).abs().max()) /
                max(float(base[k].abs().max()), 1e-30) for k in base)
    log(f"[depth11 parity] the card's two runs: gradients ≤ {moved:.3g} of "
        f"max |g| apart (grid_sample's backward adds atomically); "
        f"{cpu_s:.1f} s on the CPU; {gpu_line()}")
    return {"runs": readings, "card_runs_apart": moved, "cpu_s": cpu_s}


def depth11_reload(torch, root, tr):
    """Phase 11d: the folder 11a's ``save_model`` wrote read by a fresh
    trainer's ``load_model`` (every tensor, the optimizer state and the
    step bit-equal), then by ``depth/infer.py::run_folder`` on the card
    (8 frames → ``_disp.npy`` [1, 1, 256, 320], finite), then
    ``evaluate_depth`` of that folder's predictor over the stereo layout's
    frames with their GT depth PNGs (7 finite metrics). Returns the
    readings."""
    import numpy as np

    from endosr_torch.depth.datasets import EndovisDataset
    from endosr_torch.depth.evaluate import evaluate_depth
    from endosr_torch.depth.infer import DepthPredictor, run_folder
    from endosr_torch.depth.options import MonodepthOptions
    from endosr_torch.depth.trainer import Trainer

    folder = Path(tr.log_path) / "models/weights_0"
    fresh = Trainer(MonodepthOptions().parse(_depth11_argv(
        root, "--load_weights_folder", str(folder))), seed=99)
    if fresh.step != tr.step:
        raise AssertionError(f"[depth11 reload] step {fresh.step}")
    for name, m in tr.models.items():
        got = fresh.models[name].state_dict()
        for k, v in m.state_dict().items():
            if not torch.equal(got[k], v):
                raise AssertionError(f"[depth11 reload] {name}.{k} differs")
    for p, q in zip(tr.parameters, fresh.parameters):
        for k, v in tr.optimizer.state[p].items():
            if not torch.equal(fresh.optimizer.state[q][k], v):
                raise AssertionError(f"[depth11 reload] Adam {k} differs")
    frames = root / "eval_frames"
    frames.mkdir()
    for i in range(8):
        (frames / f"f{i}.jpg").write_bytes(
            (root / f"frames/{i * 7:010d}.jpg").read_bytes())
    torch.cuda.synchronize()
    t = time.perf_counter()
    written = run_folder(str(frames), str(folder), str(root / "disp"))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    for p in written:
        a = np.load(p)
        if a.shape != (1, 1, *DEPTH11_FEED) or not np.isfinite(a).all():
            raise AssertionError(f"[depth11 reload] {p}: {a.shape}")
    if len(written) != 8:
        raise AssertionError(f"[depth11 reload] {len(written)} maps")
    ds = EndovisDataset(str(root / "endovis"),
                        [f"seq {i}" for i in range(1, 9)], *DEPTH11_FEED,
                        [0], num_scales=1)
    metrics = evaluate_depth(DepthPredictor(str(folder)).predict_disp, ds)
    keys = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")
    if not all(math.isfinite(metrics[k]) for k in keys):
        raise AssertionError(f"[depth11 reload] metrics {metrics}")
    log(f"[depth11 reload] save_model → load_model bit-equal (networks, "
        f"Adam, step {fresh.step}); run_folder on the card read the trained "
        f"folder: 8 maps [1,1,256,320] in {run_s:.2f} s; evaluate_depth "
        f"over 8 frames with GT: " + ", ".join(
            f"{k} {metrics[k]:.4g}" for k in (*keys, "med_ratio")))
    return {"run_folder_s": run_s, "metrics": metrics}


def phase11(torch, counters):
    """Phase 11: the self-supervised depth trainer on the card (11a–11d)
    with every SR kernel's count set to 0 at its start and read at its
    end (11e: all must read 0). Writes its data under ``DEPTH11_ROOT``.
    Returns ({"depth train": launches}, readings)."""
    import gc
    import shutil

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent / DEPTH11_ROOT
    shutil.rmtree(root, ignore_errors=True)
    write_depth11(root)
    numbers = {"setup_s": time.perf_counter() - t0}
    zero_counts(counters)
    for key, fn in (("train", depth11_train), ("variants", depth11_variants),
                    ("parity", depth11_parity)):
        t = time.perf_counter()
        got = fn(torch, root)
        if key == "train":
            trained, got = got
        numbers[key] = got
        numbers[key + "_s"] = time.perf_counter() - t
        log(f"[phase 11] {key}: {numbers[key + '_s']:.1f} s")
    t = time.perf_counter()
    numbers["reload"] = depth11_reload(torch, root, trained)
    numbers["reload_s"] = time.perf_counter() - t
    trained.close()
    launches = {c.__name__: c.launches for c in counters}
    if any(launches.values()):
        raise AssertionError(f"[phase 11] SR kernels launched: {launches}")
    numbers["seconds"] = time.perf_counter() - t0
    log(f"[phase 11] no SR kernel launched ({len(launches)} counters at 0); "
        f"took {numbers['seconds']:.1f} s")
    return {"depth train": launches}, numbers


MODELS12_ROOT = "build/models12"  # under the repository root, git-ignored
DEV12 = "cuda"                  # phase 12's device (a CPU rehearsal: "cpu")
P12_STEPS = 3
P12_SR_N = (16, 2)              # 12a: training pairs (GT 128²), test (512²)
P12_SR_GT = (128, 512)
P12_REQ = (8, 128)              # a request: batch, LQ side
P12_RRDB_STEP = (16, 32)        # 12b's step: batch, LQ side
P12_IKC = (16, 64)              # 12c's steps: batch, LQ side
P12_DEPTH = (8, 64)             # 12d's steps: batch, LQ side
P12_SEG_N = 16                  # 12e: frames of CVC-ClinicDB's 384×288
P12_SEG_GT = (288, 384)
# 12e trains with the EndoScene ×2 YAML's rotations and 4 loader workers;
# 384×288 frames rotated and upright do not stack (C7, as in JAX): the
# seed is the first at which no batch of the run's 3 steps mixes them
# (16 frames, batch 8: the draws of phase 9a's EndoScene ×2 run, whose
# seed it is; found by replaying the workers' augmentation draws)
P12_SEG_SEED = 234137
P12_SEG_WANT = ({"style_blend_dot": 2, "output_stage": 1},
                {"style_blend_dot": "cuda_core", "output_stage": "vec16"})
P12_CPU = {"sr": 32, "rrdb": 16, "predictor": 32, "sftmd_kernel": 32,
           "corrector": 32, "sftmd": 32, "sftmd_depth": 16}   # 12f LQ sides
P12_LOSS_REL = 1e-5             # 12f: card vs CPU, the step's losses
P12_OUT_REL = 2e-4              # 12f: outputs, of max |ref|


class ModelTaps:
    """While installed, wraps ``optimize_parameters`` and ``test`` of the
    given model classes: every call runs with the launch counts set to 0
    just before it and read just after it (synchronised, host clock),
    recorded under ``self.label``."""

    def __init__(self, torch, counters, classes):
        self.torch, self.counters, self.classes = torch, counters, classes
        self.label, self.calls = None, {}

    def _sync(self):
        if DEV12 == "cuda":
            self.torch.cuda.synchronize()

    def install(self):
        saved = []
        for cls in self.classes:
            for name in ("optimize_parameters", "test"):
                orig = cls.__dict__.get(name)
                if orig is None:
                    continue
                saved.append((cls, name, orig))

                def wrapped(model, *a, _orig=orig, _name=name, **k):
                    self._sync()
                    zero_counts(self.counters)
                    t = time.perf_counter()
                    out = _orig(model, *a, **k)
                    self._sync()
                    self.calls.setdefault(self.label, []).append({
                        "what": _name, "secs": time.perf_counter() - t,
                        "logs": dict(model.log_dict)
                        if _name == "optimize_parameters" else None,
                        "launches": {c.__name__: c.launches
                                     for c in self.counters},
                        "routes": {c.__name__: dict(c.routes)
                                   for c in self.counters
                                   if hasattr(c, "routes")}})
                    return out

                setattr(cls, name, wrapped)

        def uninstall():
            for cls, name, orig in saved:
                setattr(cls, name, orig)

        return uninstall

    def steps(self, label):
        return [r for r in self.calls.get(label, [])
                if r["what"] == "optimize_parameters"]


def _peak_reset(torch):
    import gc

    gc.collect()
    if DEV12 == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak(torch):
    return (torch.cuda.max_memory_allocated() / 2 ** 30 if DEV12 == "cuda"
            else float("nan"))


def _timed(torch, fn, n=3):
    """(the result of the first of ``n`` + 1 calls of ``fn``, the median
    ms of the last ``n``; host clock, synchronised)."""
    out = fn()
    ms = []
    for _ in range(n):
        if DEV12 == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        if DEV12 == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return out, sorted(ms)[len(ms) // 2]


def _no_launches(label, records):
    """Every record launched no kernel (the generators besides DepthNet
    have none, as in JAX)."""
    for r in records:
        if any(r["launches"].values()):
            raise AssertionError(f"[{label}] kernel launches "
                                 f"{r['launches']}, want none")


def _finite_step_logs(label, records):
    losses = [r["logs"] for r in records]
    bad = [k for lg in losses for k, v in lg.items() if not math.isfinite(v)]
    if bad or not losses:
        raise AssertionError(f"[{label}] losses {losses}")
    return losses


def _step_ms(records):
    """(ms of each step, the median of the steps after the first)."""
    import statistics

    ms = [r["secs"] * 1e3 for r in records]
    return ms, statistics.median(ms[1:] or ms)


def _write_pairs(root, n, gt, scale, seed):
    """``n`` square pairs: GT ``gt``² and its MATLAB bicubic LR, as PNGs
    under ``root/HR`` and ``root/LR``."""
    import numpy as np

    import cv2

    rng = np.random.default_rng(seed)
    for sub in ("HR", "LR"):
        (root / sub).mkdir(parents=True)
    for i in range(n):
        img = _smooth_u8(np, rng, gt, gt)
        lr = _bicubic(np, img.astype(np.float32) / 255.0, 1 / scale)
        cv2.imwrite(str(root / "HR" / f"p{i:02d}.png"), img)
        cv2.imwrite(str(root / "LR" / f"p{i:02d}.png"),
                    np.clip(lr * 255.0, 0, 255).round().astype(np.uint8))


def _sr_opt(net, train=None, scale=4):
    """Options of an ``sr``-type model on ``net`` (``network_G``), with
    BasicSR's PSNR recipe's ``train:`` block (L1, Adam 2e-4, β 0.9 / 0.99)
    when ``train`` is given (its keys over it)."""
    opt = {"model": "sr", "scale": scale, "is_train": train is not None,
           "network_G": net, "path": {}, "datasets": {}}
    if train is not None:
        opt["train"] = {"lr_G": 2e-4, "lr_scheme": "MultiStepLR",
                        "lr_steps": [], "beta1": 0.9, "beta2": 0.99,
                        "pixel_criterion": "l1", "pixel_weight": 1.0,
                        "manual_seed": 0, **train}
    return opt


def _rand(torch, gen, *shape):
    return torch.rand(shape, generator=gen, device=DEV12)


def p12_sr(torch, counters, root, taps):
    """12a: MSRResNet ×4 (nf 64, nb 16) in BasicSR's recipe through
    ``python -m endosr_torch.train`` (``main``) on 16 pairs of GT 128², 3
    steps; ``endosr_torch.test`` on 2 images of GT 512²; ``SRModel.test_x8``
    on a batch of 8 LQ 128²."""
    import yaml

    import endosr_torch.test as entry_test
    import endosr_torch.train as entry_train
    from endosr_torch.models import create_model
    from endosr_torch.models.recipes import msrresnet_x4_yaml

    data = root / "sr_data"
    _write_pairs(data / "train", P12_SR_N[0], P12_SR_GT[0], 4, 21)
    _write_pairs(data / "test", P12_SR_N[1], P12_SR_GT[1], 4, 22)
    y = msrresnet_x4_yaml(str(root / "sr_run"), str(data / "train/HR"),
                          str(data / "train/LR"), str(data / "test/HR"),
                          str(data / "test/LR"))
    changes = {"train.niter": P12_STEPS, "train.val_freq": 1000,
               "logger.print_freq": 1,
               "logger.save_checkpoint_freq": P12_STEPS,
               "datasets.train.dataset_enlarge_ratio": 1}
    for key, value in changes.items():
        *parents, leaf = key.split(".")
        node = y
        for part in parents:
            node = node[part]
        log(f"[12a] reduced: BasicSR train_MSRResNet_x4 {key}: "
            f"{node[leaf]!r} → {value!r}")
        node[leaf] = value
    yml = root / "sr_x4.yml"
    yml.write_text(yaml.safe_dump(y))
    args = ["-opt_F", str(yml)] + ([] if DEV12 == "cuda" else
                                   ["--device", "cpu"])
    taps.label = "12a sr train"
    _peak_reset(torch)
    model = entry_train.main(args)
    peak = _peak(torch)
    steps = taps.steps(taps.label)
    if len(steps) != P12_STEPS:
        raise AssertionError(f"[12a] {len(steps)} steps")
    losses = _finite_step_logs("12a", steps)
    _no_launches("12a", steps)
    ms, step_ms = _step_ms(steps)
    weights = root / "sr_run/experiments/sr_x4/models/latest_G.pth"
    t = {"name": "sr_x4_test", "model": "sr", "scale": 4,
         "datasets": {"test_1": {"name": "test", "mode": "LQGTker",
                                 "data_type": "img",
                                 "dataroot_GT": str(data / "test/HR"),
                                 "dataroot_LQ": str(data / "test/LR")}},
         "network_G": y["network_G"],
         "path": {"root": str(root / "sr_eval"), "strict_load": True,
                  "pretrain_model_G": str(weights)}}
    tyml = root / "sr_x4_test.yml"
    tyml.write_text(yaml.safe_dump(t))
    taps.label = "12a sr test"
    entry_test.main(["-opt_F", str(tyml)] + args[2:])
    served = taps.calls[taps.label]
    _no_launches("12a test", served)
    tsv = next((root / "sr_eval/results").iterdir()) / "result_x4.tsv"
    rows = tsv.read_text().splitlines()
    if len(rows) != P12_SR_N[1] + 2 or not rows[-1].startswith("Average"):
        raise AssertionError(f"[12a] test.main wrote {rows}")
    psnr = float(rows[-1].split("\t")[1])
    # the 8-view self-ensemble on a batch
    m = create_model(dict(_sr_opt(y["network_G"]), path={
        "pretrain_model_G": str(weights), "strict_load": True}),
        device=DEV12 if DEV12 == "cpu" else None)
    gen = torch.Generator(device=DEV12).manual_seed(12)
    b, side = P12_REQ
    m.feed_data({"LQ": _rand(torch, gen, b, side, side, 3)})
    _peak_reset(torch)
    sr, x8_ms = _timed(torch, m.test_x8, 2)
    x8_peak = _peak(torch)
    if tuple(sr.shape) != (b, side * 4, side * 4, 3) or not bool(
            torch.isfinite(sr).all()):
        raise AssertionError(f"[12a] test_x8 {tuple(sr.shape)}")
    req = [r["secs"] * 1e3 for r in served]
    del model, m, sr
    out = {"ms": ms, "ms_per_step": step_ms, "peak_gib": peak,
           "losses": [lg["l_pix"] for lg in losses],
           "test_ms": req, "test_psnr_db": psnr, "test_x8_ms": x8_ms,
           "test_x8_peak_gib": x8_peak}
    log(f"[12a] sr MSRResNet ×4 (nf 64, nb 16), fp32, batch 16, GT 128², "
        f"train.main: step ms " + ", ".join(f"{x:.1f}" for x in ms)
        + f" (median of steps 2–3 {step_ms:.1f}); peak {peak:.2f} GiB; "
        f"l_pix {out['losses']}; test.main, 2 images LQ 128² → 512²: "
        + ", ".join(f"{x:.1f}" for x in req) + f" ms a request, PSNR "
        f"{psnr:.2f} dB (3 steps from random weights); test_x8 batch "
        f"{b}, LQ {side}²: {x8_ms:.1f} ms, peak {x8_peak:.2f} GiB; kernel "
        f"launches 0; {gpu_line() if DEV12 == 'cuda' else 'cpu'}")
    return out


def p12_rrdb(torch, taps):
    """12b: RRDBNet (nf 64, nb 23, gc 32, ×4), a batch-8 request at LQ 128²
    and training steps at batch 16, LQ 32² (GT 128²)."""
    from endosr_torch.models import create_model

    net = {"which_model_G": "RRDBNet", "nf": 64, "nb": 23}
    m = create_model(_sr_opt(net, {}), device=None if DEV12 == "cuda"
                     else DEV12)
    gen = torch.Generator(device=DEV12).manual_seed(13)
    b, side = P12_REQ
    m.feed_data({"LQ": _rand(torch, gen, b, side, side, 3)})
    taps.label = "12b rrdb request"
    _peak_reset(torch)
    sr, req_ms = _timed(torch, m.test)
    req_peak = _peak(torch)
    if tuple(sr.shape) != (b, side * 4, side * 4, 3) or not bool(
            torch.isfinite(sr).all()):
        raise AssertionError(f"[12b] request {tuple(sr.shape)}")
    bs, ls = P12_RRDB_STEP
    m.feed_data({"LQ": _rand(torch, gen, bs, ls, ls, 3),
                 "GT": _rand(torch, gen, bs, ls * 4, ls * 4, 3)})
    taps.label = "12b rrdb train"
    _peak_reset(torch)
    for n in range(P12_STEPS):
        m.optimize_parameters(n + 1)
    peak = _peak(torch)
    steps = taps.steps(taps.label)
    losses = _finite_step_logs("12b", steps)
    _no_launches("12b", taps.calls["12b rrdb request"] + steps)
    ms, step_ms = _step_ms(steps)
    # multiply-adds an LQ pixel: the trunk at LQ, the upsampling at 2× and
    # 4× (upconv1 at 2×, upconv2, HRconv and conv_last at 4×)
    trunk = 23 * 3 * sum((64 + 32 * i) * (32 if i < 4 else 64) * 9
                         for i in range(5)) + 2 * 64 * 64 * 9 + 3 * 64 * 9
    macs = trunk + 4 * 64 * 64 * 9 + 16 * (2 * 64 * 64 * 9 + 64 * 3 * 9)
    tflop = 2 * macs * b * side * side / 1e12
    del m, sr
    out = {"request_ms": req_ms, "request_peak_gib": req_peak,
           "request_tflop": tflop, "ms": ms, "ms_per_step": step_ms,
           "peak_gib": peak, "losses": [lg["l_pix"] for lg in losses],
           "macs_per_lq_pixel": macs}
    log(f"[12b] RRDBNet ×4 (nf 64, nb 23, gc 32), fp32: request batch {b}, "
        f"LQ {side}² → {side * 4}²: {req_ms:.1f} ms (median of 3 after one), "
        f"{macs / 1e6:.2f} M multiply-adds an LQ pixel, {tflop:.2f} TFLOP, "
        f"{tflop / req_ms * 1e3:.1f} TFLOP/s; peak {req_peak:.2f} GiB; "
        f"train batch {bs}, LQ {ls}²: step ms "
        + ", ".join(f"{x:.1f}" for x in ms)
        + f" (median of steps 2–3 {step_ms:.1f}), peak {peak:.2f} GiB; "
        f"kernel launches 0; {gpu_line() if DEV12 == 'cuda' else 'cpu'}")
    return out


def _ikc_opts(code=10):
    t = {"lr_G": 1e-4}
    return {
        "predictor": dict(_sr_opt({"which_model_G": "Predictor",
                                   "code_length": code}, t),
                          model="predictor"),
        "sftmd_kernel": dict(_sr_opt({"which_model_G": "SFTMD_kernel",
                                      "nf": 64, "nb": 16,
                                      "code_length": code}, t),
                             model="sftmd"),
        "corrector": dict(_sr_opt({"which_model_G": "Corrector",
                                   "code_length": code}, t),
                          model="corrector"),
    }


def p12_ikc(torch, root, taps):
    """12c: IKC. The Predictor on the ``LQker`` data (LR images with seeded
    kernel codes), the kernel-conditioned SFTMD (``SFTMD_kernel`` nf 64,
    nb 16, code 10, ×4) on LR/GT pairs with codes, the Corrector on the
    ``SRker`` data (SR images with estimated codes): 3 steps each at batch
    16, LQ 64²; then one chained request Predictor → SFTMD → Corrector at
    batch 8, LQ 128²."""
    import numpy as np

    from endosr_torch.data import create_dataloader
    from endosr_torch.data.datasets import (LQGTKerDataset, LQKerDataset,
                                            SRKerDataset)
    from endosr_torch.models import create_model

    b, side = P12_IKC
    data = root / "ikc_data"
    _write_pairs(data, b, side * 4, 4, 23)
    rng = np.random.default_rng(24)
    codes = rng.random((b, 10), dtype=np.float32)
    est = (codes + rng.normal(0, 0.05, codes.shape)).astype(np.float32)
    ds = {"phase": "train", "data_type": "img", "scale": 4, "batch_size": b,
          "use_shuffle": False}
    sets = {
        "predictor": LQKerDataset(dict(ds, dataroot_LQ=str(data / "LR")),
                                  codes),
        "sftmd_kernel": LQGTKerDataset(dict(ds, dataroot_LQ=str(data / "LR"),
                                            dataroot_GT=str(data / "HR"))),
        "corrector": SRKerDataset(dict(ds, dataroot_SR=str(data / "HR")),
                                  est),
    }
    out, models = {}, {}
    for name, opt in _ikc_opts().items():
        batch = next(iter(create_dataloader(sets[name], ds, opt)))
        if name == "sftmd_kernel":
            batch["ker_map"] = torch.from_numpy(codes)
        elif name == "corrector":
            batch["real_ker"] = torch.from_numpy(codes)
        m = models[name] = create_model(
            opt, device=None if DEV12 == "cuda" else DEV12)
        m.feed_data(batch)
        taps.label = f"12c {name}"
        _peak_reset(torch)
        for n in range(P12_STEPS):
            m.optimize_parameters(n + 1)
        peak = _peak(torch)
        steps = taps.steps(taps.label)
        losses = _finite_step_logs(taps.label, steps)
        _no_launches(taps.label, steps)
        ms, step_ms = _step_ms(steps)
        out[name] = {"ms": ms, "ms_per_step": step_ms, "peak_gib": peak,
                     "losses": [lg["l_pix"] for lg in losses]}
        log(f"[12c] {name} ({type(m.netG).__name__}), fp32, batch {b}, "
            f"{'SR ' + str(side * 4) if name == 'corrector' else 'LQ ' + str(side)}²"
            f": step ms " + ", ".join(f"{x:.1f}" for x in ms)
            + f" (median of steps 2–3 {step_ms:.1f}); peak {peak:.2f} GiB; "
            f"l_pix {out[name]['losses']}; kernel launches 0")
    # one chained request
    p, f, c = (models[k].netG for k in ("predictor", "sftmd_kernel",
                                        "corrector"))
    gen = torch.Generator(device=DEV12).manual_seed(14)
    rb, rside = P12_REQ
    lq = _rand(torch, gen, rb, rside, rside, 3)

    @torch.inference_mode()
    def chain():
        code = p(lq)
        sr = f(lq, code)
        return code, sr, c(sr, code)

    _peak_reset(torch)
    (code, sr, fixed), ms = _timed(torch, chain)
    peak = _peak(torch)
    if (tuple(sr.shape) != (rb, rside * 4, rside * 4, 3)
            or tuple(fixed.shape) != (rb, 10)
            or not all(bool(torch.isfinite(t).all())
                       for t in (code, sr, fixed))):
        raise AssertionError("[12c] chained request")
    out["chain_ms"], out["chain_peak_gib"] = ms, peak
    log(f"[12c] chained request Predictor → SFTMD → Corrector, batch {rb}, "
        f"LQ {rside}² → {rside * 4}²: {ms:.1f} ms (median of 3 after one), "
        f"peak {peak:.2f} GiB; {gpu_line() if DEV12 == 'cuda' else 'cpu'}")
    return out


def _depth_opts():
    t = {"lr_G": 1e-4, "depth_l1_weight": 1.0, "depth_ssim_weight": 1.0}
    return {
        "sftmd": dict(_sr_opt({"which_model_G": "SFTMD", "nf": 64, "nb": 16},
                              t), model="sftmd"),
        "sftmd_depth": dict(_sr_opt(
            {"which_model_G": "SFTMD_upsacle_after_ResBlk_depth", "nf": 64,
             "nb": 16, "predict_depth_map": True, "n_depthResBlk": 3}, t,
            scale=8), model="sftmd_depth"),
    }


def _depth_batch(torch, gen, b, side, scale):
    out = {"LQ": _rand(torch, gen, b, side, side, 3),
           "GT": _rand(torch, gen, b, side * scale, side * scale, 3)}
    if scale == 8:
        for k, f in (("Depth_x8", 1), ("Depth_x4", 2), ("Depth_x2", 4)):
            out[k] = _rand(torch, gen, b, side * f, side * f, 1)
    return out


def p12_depth(torch, taps):
    """12d: the SFTMD depth line. ``sftmd`` (``SFTMD`` = the kernel-free
    variant, ×4) and ``sftmd_depth`` (``SFTMD_upsacle_after_ResBlk_depth``,
    the learned depth maps, 3 SPADE blocks, ×8): 3 steps each at batch 8,
    LQ 64²; one batch-8 forward each of ``SFTMD_upsacle_after_ResBlk`` and
    its ``_depth_condition`` variant (every block a depth block) at LQ
    128² → 1024²."""
    from endosr_torch.nn.networks import define_G
    from endosr_torch.utils.port_params import seeded_init

    b, side = P12_DEPTH
    gen = torch.Generator(device=DEV12).manual_seed(15)
    out = {}
    from endosr_torch.models import create_model

    for name, opt in _depth_opts().items():
        m = create_model(opt, device=None if DEV12 == "cuda" else DEV12)
        m.feed_data(_depth_batch(torch, gen, b, side, opt["scale"]))
        taps.label = f"12d {name}"
        _peak_reset(torch)
        for n in range(P12_STEPS):
            m.optimize_parameters(n + 1)
        peak = _peak(torch)
        steps = taps.steps(taps.label)
        losses = _finite_step_logs(taps.label, steps)
        _no_launches(taps.label, steps)
        ms, step_ms = _step_ms(steps)
        out[name] = {"ms": ms, "ms_per_step": step_ms, "peak_gib": peak,
                     "losses": losses}
        log(f"[12d] {name} ({type(m.netG).__name__}, ×{opt['scale']}), fp32, "
            f"batch {b}, LQ {side}²: step ms " + ", ".join(f"{x:.1f}"
                                                          for x in ms)
            + f" (median of steps 2–3 {step_ms:.1f}); peak {peak:.2f} GiB; "
            f"losses {losses[-1]}; kernel launches 0")
        del m
    rb, rside = P12_REQ
    lq = _rand(torch, gen, rb, rside, rside, 3)
    dep = _rand(torch, gen, rb, rside, rside, 1)
    for which, extra, args in (
            ("SFTMD_upsacle_after_ResBlk", {}, (lq,)),
            ("SFTMD_upsacle_after_ResBlk_depth_condition",
             {"which_ResBlk_depth": list(range(16))}, (lq, dep))):
        net = seeded_init(define_G(
            {"scale": 8, "network_G": {"which_model_G": which, "nf": 64,
                                       "nb": 16, **extra}},
            device=None if DEV12 == "cuda" else DEV12), 16).eval()
        _peak_reset(torch)
        with torch.inference_mode():
            sr, ms = _timed(torch, lambda: net(*args))
        peak = _peak(torch)
        if tuple(sr.shape) != (rb, rside * 8, rside * 8, 3) or not bool(
                torch.isfinite(sr).all()) or float(sr.min()) < 0 or float(
                sr.max()) > 1:
            raise AssertionError(f"[12d] {which} {tuple(sr.shape)}")
        out[which] = {"request_ms": ms, "request_peak_gib": peak}
        log(f"[12d] {which}, fp32, batch {rb}, LQ {rside}² → {rside * 8}²: "
            f"{ms:.1f} ms (median of 3 after one), peak {peak:.2f} GiB")
        del net, sr
    log(f"[12d] {gpu_line() if DEV12 == 'cuda' else 'cpu'}")
    return out


def write_clinicdb(root, n, gt_hw, scale, seed=31):
    """``n`` synthetic frames of GT ``gt_hw`` (CVC-ClinicDB's 384×288), LR
    under ``LR/x<scale>/`` the MATLAB bicubic, ``<stem>_disp.npy`` depth
    at the LR size, polyp masks under ``seg/`` (an ellipse a frame) and
    ``train.txt`` naming the frames."""
    import numpy as np

    import cv2

    rng = np.random.default_rng(seed)
    for sub in ("HR", f"LR/x{scale}", "depth", "seg"):
        (root / sub).mkdir(parents=True)
    names = [f"{i + 1}.png" for i in range(n)]
    h, w = gt_hw
    for name in names:
        gt = _smooth_u8(np, rng, h, w)
        lr = _bicubic(np, gt.astype(np.float32) / 255.0, 1 / scale)
        lr = np.clip(lr * 255.0, 0, 255).round().astype(np.uint8)
        cv2.imwrite(str(root / "HR" / name), gt)
        cv2.imwrite(str(root / f"LR/x{scale}" / name), lr)
        np.save(root / "depth" / f"{name[:-4]}_disp.npy",
                rng.random((1, 1) + lr.shape[:2], dtype=np.float32))
        seg = np.zeros((h, w), np.uint8)
        cv2.ellipse(seg, (int(rng.integers(w // 4, 3 * w // 4)),
                          int(rng.integers(h // 4, 3 * h // 4))),
                    (int(rng.integers(20, w // 4)),
                     int(rng.integers(20, h // 4))), 0, 0, 360, 255, -1)
        cv2.imwrite(str(root / "seg" / name), seg)
    (root / "train.txt").write_text("".join(x + "\n" for x in names))


def p12_seg(torch, counters, root, taps, tap):
    """12e: ``sftmd_depthSegNet`` (the EndoScene ×2 YAML's DepthNet, FCN8s
    of 2 classes, ``models/recipes.py::depthseg_yaml``) through ``python
    -m endosr_torch.train`` on 16 frames of 384×288, batch 8, 3 steps:
    launches and routes of the DepthNet kernels asserted a step (each call
    recorded by ``tap`` for the kernel checks after), the FCN's BatchNorm
    statistics finite. Then one fp32 batch-2 step against ``preset:
    plain`` by phase 6b's rule (``parity_runs`` / ``parity_readings``)."""
    import yaml

    import endosr_torch.train as entry_train
    from endosr_torch.models.f_depthseg import FModelDepthSeg
    from endosr_torch.models.recipes import depthseg_yaml

    data = root / "seg_data"
    write_clinicdb(data, P12_SEG_N, P12_SEG_GT, 2)
    y = depthseg_yaml(str(root / "seg_run"), str(data / "HR"),
                      str(data / "LR"), str(data / "depth"),
                      str(data / "seg"), str(data / "train.txt"))
    changes = {"train.niter": P12_STEPS, "train.val_freq": 1000,
               "train.manual_seed": P12_SEG_SEED, "logger.print_freq": 1,
               "logger.save_checkpoint_freq": P12_STEPS,
               "datasets.train.data_num": P12_SEG_N}
    for key, value in changes.items():
        *parents, leaf = key.split(".")
        node = y
        for part in parents:
            node = node[part]
        log(f"[12e] reduced: endoscene_x2 co-training {key}: "
            f"{node.get(leaf)!r} → {value!r}")
        node[leaf] = value
    yml = root / "depthseg_x2.yml"
    yml.write_text(yaml.safe_dump(y))
    taps.label = tap.where = "12e depthseg train"
    _peak_reset(torch)
    model = entry_train.main(["-opt_F", str(yml)] + (
        [] if DEV12 == "cuda" else ["--device", "cpu"]))
    peak = _peak(torch)
    steps = taps.steps(taps.label)
    if len(steps) != P12_STEPS:
        raise AssertionError(f"[12e] {len(steps)} steps")
    losses = _finite_step_logs("12e", steps)
    if DEV12 == "cuda":
        check_launches("12e", steps, *P12_SEG_WANT)
    stats = {k: v for k, v in model.segNet.state_dict().items()
             if "running" in k}
    if not all(bool(torch.isfinite(v).all()) for v in stats.values()):
        raise AssertionError("[12e] BatchNorm statistics not finite")
    models = root / "seg_run/experiments/depthseg_x2/models"
    for f in (f"{P12_STEPS}_segNet.pth", "latest_segNet.pth",
              "latest_G.pth"):
        if not (models / f).is_file():
            raise AssertionError(f"[12e] no {f}")
    ms, step_ms = _step_ms(steps)
    launches = {c.__name__: sum(r["launches"][c.__name__] for r in steps)
                for c in counters}
    del model
    out = {"ms": ms, "ms_per_step": step_ms, "peak_gib": peak,
           "losses": losses}
    log(f"[12e] sftmd_depthSegNet, EndoScene ×2 DepthNet + FCN8s, fp32, "
        f"batch 8 of 384×288 (LQ 192×144), train.main: step ms "
        + ", ".join(f"{x:.1f}" for x in ms)
        + f" (median of steps 2–3 {step_ms:.1f}); peak {peak:.2f} GiB; "
        + ", ".join(f"{k} {v}" for k, v in P12_SEG_WANT[0].items())
        + " launches a step (" + ", ".join(f"{k} {v}" for k, v in
                                            P12_SEG_WANT[1].items())
        + f"); l_all {[lg['l_all'] for lg in losses]}, l_segBCE "
        f"{[lg['l_segBCE'] for lg in losses]}; BatchNorm statistics finite; "
        f"{gpu_line() if DEV12 == 'cuda' else 'cpu'}")
    if DEV12 == "cuda":
        out["parity"] = _seg_parity(torch, y)
    return launches, out


def _seg_parity(torch, y):
    """12e's fp32 batch-2 step (LQ 144×192, GT 288×384 with segmentation
    labels) of the default DepthNet against ``preset: plain``, by phase
    6b's rule."""
    from endosr_torch.models.f_depthseg import FModelDepthSeg

    def opt_of(**net):
        return {"is_train": True, "model": "sftmd_depthSegNet", "scale": 2,
                "precision": None,
                "datasets": {"train": {"depthMaskNum": 10}},
                "network_G": {**y["network_G"], **net},
                "network_SegNet": {"num_classes": 2},
                "path": {}, "train": copy.deepcopy(y["train"])}

    batch = parity_batch(torch, 2, (P12_SEG_GT[0] // 2, P12_SEG_GT[1] // 2))
    gen = torch.Generator(device="cuda").manual_seed(17)
    seg = torch.rand(P12_SEG_GT, generator=gen, device="cuda") > 0.5
    seg = torch.stack([~seg, seg], -1).float()[None].expand(2, -1, -1, -1)
    batch["SegLabel"] = seg.contiguous()
    runs = parity_runs(torch, opt_of, batch, model=FModelDepthSeg)
    return train_parity(torch, runs, "12e parity: sftmd_depthSegNet default "
                        "vs preset: plain")


# 12f's one-ulp nudges (phase 6b's four), run on the card and on the CPU:
# (label, the input's direction or None, the weights' seed or None)
P12_NUDGES = (("LQ + 1 ulp", 1.0, None), ("LQ - 1 ulp", -1.0, None),
              ("weights ± 1 ulp (a)", None, 7), ("weights ± 1 ulp (b)", None,
                                                 8))


def _cpu_twin(torch, opt, batch_card, lq_key, step=1, nets=("netG",),
              device=None):
    """12f / 13f for one model: step ``step`` from the same seeded weights
    on the card (``device``; None: the models' default, CUDA) and on the
    CPU, each also under ``P12_NUDGES`` (phase 6b's yardstick, on both
    sides); the output of ``test`` on both. ``nets``: the model's networks
    whose parameters are seeded alike, nudged and read (keys
    ``<net>.<name>``); a model with a ``netD`` also gives D's running
    statistics before (``stats0``) and after (``stats``) the step."""
    from endosr_torch.models import create_model

    def named(m):
        return {f"{n}.{k}": p for n in nets
                for k, p in getattr(m, n).named_parameters()}

    def running(m):
        return {k: v.detach().cpu().clone()
                for k, v in m.netD.state_dict().items() if "running" in k}

    def run(dev, feed, nudge_seed, serve):
        m = create_model(copy.deepcopy(opt), device=dev)
        start = {k: p.detach().cpu().clone() for k, p in named(m).items()}
        if nudge_seed is not None:
            start = _nudge_weights(torch, start, nudge_seed, "cpu")
            with torch.no_grad():
                for k, p in named(m).items():
                    p.copy_(start[k])
        has_d = getattr(m, "netD", None) is not None
        r = {"start": start, **({"stats0": running(m)} if has_d else {})}
        m.feed_data(feed)
        r["logs"] = dict(m.optimize_parameters(step))
        r["params"] = {k: p.detach().cpu().clone()
                       for k, p in named(m).items()}
        if has_d:
            r["stats"] = running(m)
        if serve:
            with torch.no_grad():
                for k, p in named(m).items():
                    p.copy_(start[k])
            out = m.test()
            r["out"] = [t.detach().float().cpu() for t in (
                out if isinstance(out, tuple) else (out,))] + (
                [m.depth_x4.cpu(), m.depth_x2.cpu()]
                if getattr(m, "depth_x4", None) is not None else [])
        del m
        return r

    runs = {}
    for side, dev in (("card", device), ("cpu", "cpu")):
        base = batch_card if side == "card" else {
            k: v.cpu() for k, v in batch_card.items()}
        runs[side] = run(dev, base, None, True)
        for label, to, seed in P12_NUDGES:
            feed = base
            if to is not None:
                x = base[lq_key]
                feed = dict(base, **{lq_key: torch.nextafter(x, x + to)})
            runs[f"{side} {label}"] = run(dev, feed, seed, False)
    return runs


def _apart(a, b, key="params", start="start"):
    """‖a − b‖ / ‖b − b's start‖ over the tensors of ``key``."""
    num = sum(float((a[key][k] - b[key][k]).square().sum()) for k in b[key])
    den = sum(float((b[key][k] - b[start][k]).square().sum()) for k in b[key])
    return (num / den) ** 0.5


def p12_card_vs_cpu(torch):
    """12f: for each model of 12a–12d (MSRResNet, RRDBNet, the Predictor,
    the kernel-conditioned SFTMD, the Corrector, the kernel-free SFTMD and
    the depth variant, full width, batch 2, small LQ: ``P12_CPU``), step 1
    on the card and on the CPU from the same seeded weights and batch: the
    losses within ``P12_LOSS_REL`` relative, ``test``'s outputs within
    ``P12_OUT_REL`` of max |ref|, the updated parameters apart by no more
    than ``GRAD_NOISE``× the largest change either side's own step makes
    under phase 6b's four one-ulp nudges (``P12_NUDGES``; norm over all,
    of the step's move). cuDNN's deterministic algorithms."""
    import numpy as np

    cudnn = torch.backends.cudnn
    was = cudnn.deterministic
    cudnn.deterministic = True
    gen = torch.Generator(device="cuda").manual_seed(18)
    t = {"lr_G": 1e-4}
    opts = {"sr": _sr_opt({"which_model_G": "MSRResNet", "nf": 64, "nb": 16},
                          t),
            "rrdb": _sr_opt({"which_model_G": "RRDBNet", "nf": 64, "nb": 23},
                            t),
            **_ikc_opts(), **_depth_opts()}
    out = {}
    try:
        for name, opt in opts.items():
            s = P12_CPU[name]
            scale = opt["scale"]
            lq_key = "SR" if name == "corrector" else "LQ"
            if name in ("predictor", "corrector"):
                side = s * 4 if name == "corrector" else s
                batch = {lq_key: _rand(torch, gen, 2, side, side, 3),
                         "real_ker": _rand(torch, gen, 2, 10)}
                if name == "corrector":
                    batch["est_ker_map"] = _rand(torch, gen, 2, 10)
            else:
                batch = _depth_batch(torch, gen, 2, s, scale)
                if name == "sftmd_kernel":
                    batch["ker_map"] = _rand(torch, gen, 2, 10)
            opt = dict(opt, train=dict(opt["train"], manual_seed=19))
            runs = _cpu_twin(torch, opt, batch, lq_key)
            card, cpu = runs["card"], runs["cpu"]
            if any(not torch.equal(card["start"][k], v)
                   for k, v in cpu["start"].items()):
                raise AssertionError(f"[12f] {name}: the seeded weights differ")
            loss_rel = max(abs(card["logs"][k] - v) / max(abs(v), 1e-12)
                           for k, v in cpu["logs"].items())
            out_rel = max(float((a - b).abs().max())
                          / max(float(b.abs().max()), 1e-12)
                          for a, b in zip(card["out"], cpu["out"]))
            prel = _apart(card, cpu)
            prel_n = max(_apart(runs[f"{side} {lab}"], runs[side])
                         for side in ("card", "cpu")
                         for lab, *_ in P12_NUDGES)
            fails = []
            if sorted(card["logs"]) != sorted(cpu["logs"]) or not (
                    loss_rel <= P12_LOSS_REL):
                fails.append(f"losses {loss_rel:.3g} relative")
            if not out_rel <= P12_OUT_REL:
                fails.append(f"outputs {out_rel:.3g} of max |ref|")
            if not prel <= GRAD_NOISE * prel_n:
                fails.append(f"updated parameters {prel:.3g} of the move "
                             f"apart > {GRAD_NOISE}× the one-ulp change "
                             f"{prel_n:.3g}")
            out[name] = {"loss_rel": loss_rel, "out_rel": out_rel,
                         "params_rel": prel, "params_rel_ulp": prel_n}
            log(f"[12f] {name}, batch 2, LQ {s}², card vs CPU: losses "
                f"{loss_rel:.3g} relative (tol {P12_LOSS_REL:g}); outputs "
                f"{out_rel:.3g} of max |ref| (tol {P12_OUT_REL:g}); updated "
                f"parameters {prel:.3g} of the move apart (the largest change "
                f"under the four one-ulp nudges on either side: "
                f"{prel_n:.3g}, tol {GRAD_NOISE}× that)"
                + (f" FAILED: {'; '.join(fails)}" if fails else ""))
            if fails:
                raise AssertionError(f"[12f] {name}: " + "; ".join(fails))
            del runs
            torch.cuda.empty_cache()
    finally:
        cudnn.deterministic = was
    return out


def phase12(torch, counters):
    """Phase 12: the other models (12a–12f), fp32 with TF32 off, seeded
    weights, synthetic data written with ``cv2`` under ``build/models12``.
    Returns ({path label: launches}, readings)."""
    import shutil

    from endosr_torch.models.common import SimpleModel
    from endosr_torch.models.f_depthseg import FModelDepthSeg
    from endosr_torch.models.f_depth import FModelDepth
    from endosr_torch.models.p_model import PModel
    from endosr_torch.models.c_model import CModel
    from endosr_torch.models.sr_model import SRModel

    root = Path(__file__).resolve().parent / MODELS12_ROOT
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    taps = ModelTaps(torch, counters, (SimpleModel, SRModel, PModel, CModel,
                                       FModelDepth, FModelDepthSeg))
    tap = KernelTap()
    numbers, launches = {}, {}
    uninstall = taps.install()
    try:
        for key, fn in (("12a", lambda: p12_sr(torch, counters, root, taps)),
                        ("12b", lambda: p12_rrdb(torch, taps)),
                        ("12c", lambda: p12_ikc(torch, root, taps)),
                        ("12d", lambda: p12_depth(torch, taps))):
            t = time.perf_counter()
            numbers[key] = fn()
            numbers[key + "_s"] = time.perf_counter() - t
            log(f"[phase 12] {key}: {numbers[key + '_s']:.1f} s")
        t = time.perf_counter()
        # (the tap reads the routes a launch took: on the card only)
        untap = tap.install() if DEV12 == "cuda" else (lambda: None)
        try:
            launches["12e depthseg train"], numbers["12e"] = p12_seg(
                torch, counters, root, taps, tap)
        finally:
            untap()
        numbers["12e_s"] = time.perf_counter() - t
        log(f"[phase 12] 12e: {numbers['12e_s']:.1f} s")
    finally:
        uninstall()
    for label, recs in taps.calls.items():
        if label.startswith("12e"):
            continue
        launches[label] = {c.__name__: sum(r["launches"][c.__name__]
                                           for r in recs) for c in counters}
    if DEV12 == "cuda":
        t = time.perf_counter()
        numbers["kernel_max_abs_err"], numbers["kernels"] = \
            phase9_kernel_checks(torch, tap.calls, "phase 12 kernels",
                                 controls=False)
        numbers["kernels_s"] = time.perf_counter() - t
        t = time.perf_counter()
        numbers["12f"] = p12_card_vs_cpu(torch)
        numbers["12f_s"] = time.perf_counter() - t
        log(f"[phase 12] 12f: {numbers['12f_s']:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    numbers["seconds"] = time.perf_counter() - t0
    log(f"[phase 12] took {numbers['seconds']:.1f} s")
    return launches, numbers


GAN13_ROOT = "build/gan13"     # under the repository root, git-ignored
DEV13 = "cuda"                  # phase 13's device (a CPU rehearsal: "cpu")
P13_STEPS = 3
P13_GAN = (16, 32)              # 13a/13b: batch, LR side (GT 128²)
P13_SFT = (16, 24)              # 13c: batch, LR side (HR 96²)
P13_SFT_STEPS = (1, 2, 20001)
P13_REQ = (8, 128)              # 13d: batch, LR side (segmentation 512²)
P13_DATA = (16, 480, 4)         # 13e: images 480², background images
P13_SRMD = (16, 256, 4, 21)     # 13e: batch, HR side, scale, kernel size
P13_CPU_NB = {"RRDBNet": 2, "MSRResNet": 4}   # 13f: G's depth on the CPU
P13_LOSS_REL = 1e-6             # 13f: card vs CPU, the step's losses
# 13f: the logs computed from D's outputs (its logits' means and the GAN
# terms), also held by the nudge rule
P13_D_LOGS = ("D_real", "D_fake", "l_g_gan", "l_d_real", "l_d_fake",
              "l_g_cls", "l_d_cls_real", "l_d_cls_fake")
P13_OUT_REL = 1e-5              # 13f: outputs, of max |ref|
P13_DEG_REL = 1e-5              # 13f: degradation on the same draws
# ESRGAN's published x4 recipe (BasicSR ``train_ESRGAN_x4``): RRDBNet nf
# 64, nb 23, gc 32; VGG-128 D nf 64; Adam 1e-4, β 0.9 / 0.99 for both;
# L1 pixel 1e-2, L1 VGG54 feature 1, RaGAN 5e-3, D every step
ESRGAN_TRAIN = {"lr_G": 1e-4, "lr_D": 1e-4, "beta1": 0.9, "beta2": 0.99,
                "beta1_D": 0.9, "beta2_D": 0.99, "weight_decay_G": 0,
                "weight_decay_D": 0, "lr_scheme": "MultiStepLR",
                "lr_steps": [50000, 100000, 200000, 300000],
                "lr_gamma": 0.5, "pixel_criterion": "l1",
                "pixel_weight": 1e-2, "feature_criterion": "l1",
                "feature_weight": 1.0, "gan_type": "ragan",
                "gan_weight": 5e-3, "D_update_ratio": 1, "D_init_iters": 0,
                "manual_seed": 10}
# SFT-GAN's recipe (the reference's ``train_sftgan.json``): Adam 1e-4,
# β1 0.9; pixel 1, VGG feature 1, GAN 5e-3
SFT_TRAIN = {"lr_G": 1e-4, "lr_D": 1e-4, "beta1_G": 0.9, "beta1_D": 0.9,
             "lr_scheme": "MultiStepLR", "lr_steps": [50000, 100000],
             "lr_gamma": 0.5, "pixel_criterion": "l1", "pixel_weight": 1.0,
             "feature_criterion": "l1", "feature_weight": 1.0,
             "gan_type": "gan", "gan_weight": 5e-3, "D_update_ratio": 1,
             "D_init_iters": 0, "manual_seed": 10}
G13_KEYS = {"l_g_pix", "l_g_gan"}
D13_KEYS = {"l_d_real", "l_d_fake", "D_real", "D_fake"}


def _gan13_opt(model, net_g, train, lr_size, vgg=None, net_d=None):
    t = dict(train)
    if vgg is None:
        t["feature_weight"] = 0
    else:
        t["vgg_weights_path"] = vgg
    opt = {"model": model, "scale": 4, "is_train": True,
           "network_G": net_g, "path": {}, "train": t,
           "datasets": {"train": {"LR_size": lr_size}}}
    if net_d:
        opt["network_D"] = net_d
    return opt


def _dev13():
    return None if DEV13 == "cuda" else DEV13


def _gan13_batch(torch, gen, b, lr, sft=False):
    gt = torch.rand((b, 4 * lr, 4 * lr, 3), generator=gen, device=DEV13)
    x = torch.rand((b, lr, lr, 3), generator=gen, device=DEV13)
    if not sft:
        return {"LQ": x, "GT": gt}
    seg = torch.rand((b, 4 * lr, 4 * lr, 8), generator=gen, device=DEV13)
    cat = torch.randint(0, 8, (b,), generator=gen, device=DEV13)
    return {"LR": x, "GT": gt, "seg": seg / seg.sum(-1, keepdim=True),
            "category": cat}


def _gan_steps(torch, taps, label, m, batch, steps):
    """``steps`` of ``m`` on ``batch`` under ``taps`` (label ``label``):
    (the step records, peak GiB); every loss finite, no kernel launch, the
    logs' keys those of each step's gate."""
    taps.label = label
    m.feed_data(batch)
    _peak_reset(torch)
    for step in steps:
        m.optimize_parameters(step)
    peak = _peak(torch)
    recs = taps.steps(label)
    if len(recs) != len(steps):
        raise AssertionError(f"[{label}] {len(recs)} steps")
    _finite_step_logs(label, recs)
    _no_launches(label, recs)
    sft = m.lq_key == "LR"
    for step, r in zip(steps, recs):
        want = set(D13_KEYS) | ({"l_d_cls_real", "l_d_cls_fake"} if sft
                                else set())
        if m._do_g(step):
            want |= G13_KEYS | ({"l_g_fea"} if m.cri_fea else set()) | (
                {"l_g_cls"} if sft else set())
        if set(r["logs"]) != want:
            raise AssertionError(f"[{label}] step {step} logs "
                                 f"{sorted(r['logs'])}, want {sorted(want)}")
    return recs, peak


def p13_esrgan(torch, root, taps, vgg):
    """13a: ESRGAN at its published recipe, 3 steps at batch 16, LR 32²."""
    from endosr_torch.models import create_model

    b, lr = P13_GAN
    opt = _gan13_opt("srgan", {"which_model_G": "RRDBNet", "nf": 64,
                               "nb": 23}, ESRGAN_TRAIN, lr, vgg,
                     {"which_model_D": "discriminator_vgg_128", "nf": 64})
    m = create_model(opt, device=_dev13())
    side = 4 * lr // 32                 # the reference's 128² gives 4
    if m.netD.linear1.weight.shape[1] != 512 * side * side:
        raise AssertionError(f"[13a] linear1 {tuple(m.netD.linear1.weight.shape)}")
    gen = torch.Generator(device=DEV13).manual_seed(131)
    recs, peak = _gan_steps(torch, taps, "13a esrgan", m,
                            _gan13_batch(torch, gen, b, lr), (1, 2, 3))
    ms, step_ms = _step_ms(recs)
    losses = [r["logs"] for r in recs]
    log(f"[13a] ESRGAN (RRDBNet nf 64 nb 23 gc 32, VGG-128 D nf 64, VGG19 "
        f"feature loss), ragan, fp32, batch {b}, LR {lr}² → GT {4 * lr}²: "
        f"step ms " + ", ".join(f"{x:.1f}" for x in ms) + f" (median of "
        f"steps 2–3 {step_ms:.1f}); peak {peak:.2f} GiB; step 1 logs "
        f"{losses[0]}; kernel launches 0; "
        + (gpu_line() if DEV13 == "cuda" else "cpu"))
    del m
    return {"ms": ms, "ms_per_step": step_ms, "first_ms": ms[0],
            "peak_gib": peak, "logs": losses}


def p13_srgan_losses(torch, taps):
    """13b: MSRResNet SRGAN (nf 64, nb 16) at 13a's sizes,
    ``D_update_ratio`` 2, for ``gan``, ``lsgan`` and ``wgan-gp``: a D-only
    step (1) and a G + D step (2)."""
    from endosr_torch.models import create_model

    b, lr = P13_GAN
    out = {}
    for gan_type in ("gan", "lsgan", "wgan-gp"):
        t = dict(ESRGAN_TRAIN, gan_type=gan_type, D_update_ratio=2)
        opt = _gan13_opt("srgan", {"which_model_G": "MSRResNet", "nf": 64,
                                   "nb": 16}, t, lr, None,
                         {"which_model_D": "discriminator_vgg_128", "nf": 64})
        m = create_model(opt, device=_dev13())
        gen = torch.Generator(device=DEV13).manual_seed(132)
        g0 = {k: p.detach().clone() for k, p in m.netG.named_parameters()}
        label = f"13b srgan {gan_type}"
        recs, peak = _gan_steps(torch, taps, label, m,
                                _gan13_batch(torch, gen, b, lr), (1, 2, 1, 2))
        moved = [not torch.equal(p, g0[k]) for k, p in
                 m.netG.named_parameters()]
        if not all(moved):
            raise AssertionError(f"[{label}] G did not move on its steps")
        ms = [r["secs"] * 1e3 for r in recs]
        out[gan_type] = {"d_only_ms": ms[2], "g_and_d_ms": ms[3],
                         "peak_gib": peak, "logs": [r["logs"] for r in
                                                    recs[:2]]}
        log(f"[13b] SRGAN MSRResNet (nf 64 nb 16) {gan_type}, batch {b}, LR "
            f"{lr}²: D-only step {ms[2]:.1f} ms, G + D step {ms[3]:.1f} ms "
            f"(first pair {ms[0]:.1f}, {ms[1]:.1f}); peak {peak:.2f} GiB; "
            f"G + D logs {recs[1]['logs']}")
        del m
    return out


def p13_sftgan(torch, taps, vgg):
    """13c: SFT-GAN (SFTNet, ACD_VGG_BN_96), batch 16, LR 24² → HR 96²,
    steps 1, 2 (the non-SFT parameters frozen) and 20001 (all move)."""
    from endosr_torch.models import create_model
    from endosr_torch.models.sftgan_model import sft_mask

    b, lr = P13_SFT
    opt = _gan13_opt("sftgan", {"which_model_G": "sft_arch"}, SFT_TRAIN, lr,
                     vgg)
    m = create_model(opt, device=_dev13())
    gen = torch.Generator(device=DEV13).manual_seed(133)
    g0 = {k: p.detach().clone() for k, p in m.netG.named_parameters()}
    frozen_ok = []
    orig = m.optimize_parameters

    def step_and_check(step):
        out = orig(step)
        other = [not torch.equal(p, g0[k]) for k, p in
                 m.netG.named_parameters() if not sft_mask(k)]
        frozen_ok.append((step, any(other)))
        return out

    m.optimize_parameters = step_and_check
    recs, peak = _gan_steps(torch, taps, "13c sftgan", m,
                            _gan13_batch(torch, gen, b, lr, sft=True),
                            P13_SFT_STEPS)
    if [moved for _, moved in frozen_ok] != [False, False, True]:
        raise AssertionError(f"[13c] the non-SFT parameters moved at "
                             f"{frozen_ok}, want only at 20001")
    n_sft = sum(p.numel() for k, p in m.netG.named_parameters()
                if sft_mask(k))
    ms = [r["secs"] * 1e3 for r in recs]
    log(f"[13c] SFT-GAN (SFTNet, ACD_VGG_BN_96, VGG19 feature loss), batch "
        f"{b}, LR {lr}² → HR {4 * lr}²: steps 1, 2, 20001 ms "
        + ", ".join(f"{x:.1f}" for x in ms) + f"; peak {peak:.2f} GiB; the "
        f"non-SFT parameters frozen through step 2, moved at 20001; SFT "
        f"mask {n_sft:,d} parameters (C15); step 20001 logs {recs[-1]['logs']}")
    del m
    return {"ms": ms, "peak_gib": peak, "sft_params": n_sft,
            "logs": [r["logs"] for r in recs]}


def p13_requests(torch, taps):
    """13d: SFTNet (``SFTGANACDModel.test``) and SFTNetTorch serve a
    batch-8 request at LR 128² (segmentation 512²)."""
    from endosr_torch.models import create_model
    from endosr_torch.nn.sft_arch import SFTNetTorch
    from endosr_torch.utils.port_params import seeded_init

    b, lr = P13_REQ
    gen = torch.Generator(device=DEV13).manual_seed(134)
    batch = _gan13_batch(torch, gen, b, lr, sft=True)
    m = create_model({"model": "sftgan", "is_train": False, "scale": 4,
                      "network_G": {"which_model_G": "sft_arch"},
                      "path": {}, "datasets": {}}, device=_dev13())
    m.feed_data(batch, need_GT=False)
    taps.label = "13d sftnet request"
    _peak_reset(torch)
    sr, ms = _timed(torch, m.test, 2)
    peak = _peak(torch)
    _no_launches(taps.label, taps.calls[taps.label])
    net = seeded_init(SFTNetTorch().to(DEV13), 11).eval()

    def serve_torch():
        with torch.inference_mode():
            return net(batch["LR"], batch["seg"])

    zero = [c.launches for c in taps.counters]
    _peak_reset(torch)
    sr_t, ms_t = _timed(torch, serve_torch, 2)
    peak_t = _peak(torch)
    if [c.launches for c in taps.counters] != zero:
        raise AssertionError("[13d] SFTNetTorch launched a kernel")
    for name, y in (("SFTNet", sr), ("SFTNetTorch", sr_t)):
        if tuple(y.shape) != (b, 4 * lr, 4 * lr, 3) or not bool(
                torch.isfinite(y).all()):
            raise AssertionError(f"[13d] {name} {tuple(y.shape)}")
    log(f"[13d] requests, batch {b}, LR {lr}² (seg {4 * lr}²) → SR "
        f"{4 * lr}²: SFTNet {ms:.1f} ms (peak {peak:.2f} GiB), SFTNetTorch "
        f"{ms_t:.1f} ms (peak {peak_t:.2f} GiB); kernel launches 0")
    del m, net
    return {"sftnet_ms": ms, "sftnet_peak_gib": peak, "sftnet_torch_ms": ms_t,
            "sftnet_torch_peak_gib": peak_t}


def write_segbg(root, n, side, n_bg, seed=35):
    """``n`` smooth images of ``side``² named by the OST categories (three
    in four with an 8-channel segmentation ``.npy``) and ``n_bg``
    background images."""
    import numpy as np

    import cv2

    rng = np.random.default_rng(seed)
    cats = ("building", "plant", "mountain", "water", "sky", "grass",
            "animal", "other")
    for sub in ("hr", "bg", "seg"):
        (root / sub).mkdir(parents=True)
    for i in range(n):
        name = f"{cats[i % len(cats)]}_{i:02d}"
        cv2.imwrite(str(root / "hr" / f"{name}.png"),
                    _smooth_u8(np, rng, side, side))
        if i % 4:
            seg = rng.random((side, side, 8), dtype=np.float32)
            np.save(root / "seg" / f"{name}.npy",
                    seg / seg.sum(-1, keepdims=True))
    for i in range(n_bg):
        cv2.imwrite(str(root / "bg" / f"bg_{i}.png"),
                    _smooth_u8(np, rng, side, side))


def p13_data(torch, root, taps):
    """13e: an ``LRHR_seg_bg`` loader (4 forked workers, batch 16, HR 96²)
    over 16 images of 480²: items/s; a 13c-sized SFT-GAN step on its first
    batch; ``SRMDPreprocessing`` at batch 16, HR 256², ×4, l 21,
    anisotropic, with noise: ms a call."""
    import numpy as np

    from endosr_torch.data import create_dataloader, create_dataset
    from endosr_torch.models import create_model
    from endosr_torch.ops.degradation import (SRMDPreprocessing, pca_matrix,
                                              random_batch_kernel)

    n, side, n_bg = P13_DATA
    data = root / "segbg"
    write_segbg(data, n, side, n_bg)
    b, lr = P13_SFT
    dopt = {"name": "segbg", "mode": "LRHR_seg_bg", "phase": "train",
            "scale": 4, "GT_size": 4 * lr, "use_flip": True, "use_rot": True,
            "dataroot_GT": str(data / "hr"), "dataroot_GT_bg": str(data / "bg"),
            "dataroot_seg": str(data / "seg"), "data_type": "img",
            "batch_size": b, "n_workers": 4, "use_shuffle": True,
            "dataset_enlarge_ratio": 4}
    ds = create_dataset(dopt)
    t = time.perf_counter()
    for i in range(n):
        ds[i]
    item_ms = (time.perf_counter() - t) * 1e3 / n
    loader = create_dataloader(ds, dopt, {"train": {"manual_seed": 0}})
    loader.set_epoch(0)
    t = time.perf_counter()
    batches = list(loader)
    secs = time.perf_counter() - t
    items = sum(len(x["category"]) for x in batches)
    first = batches[0]
    shapes = {k: tuple(v.shape) for k, v in first.items()
              if hasattr(v, "shape")}
    want = {"LR": (b, lr, lr, 3), "HR": (b, 4 * lr, 4 * lr, 3),
            "GT": (b, 4 * lr, 4 * lr, 3), "seg": (b, 4 * lr, 4 * lr, 8),
            "category": (b,)}
    if shapes != want:
        raise AssertionError(f"[13e] batch shapes {shapes}")
    m = create_model(_gan13_opt("sftgan", {"which_model_G": "sft_arch"},
                                SFT_TRAIN, lr), device=_dev13())
    _gan_steps(torch, taps, "13e sftgan loader batch", m, first, (1,))
    del m
    # the degradation pipeline
    bs, hr, scale, l = P13_SRMD
    ks = random_batch_kernel(256, l, rate_iso=0.5,
                             generator=torch.Generator().manual_seed(5))
    pre = SRMDPreprocessing(scale, pca_matrix(ks.numpy()), random=True,
                            kernel=l, noise=True, rate_iso=0.0)
    gen = torch.Generator(device=DEV13).manual_seed(136)
    x = torch.rand((bs, hr, hr, 3), generator=gen, device=DEV13)
    (lr_img, code), srmd_ms = _timed(
        torch, lambda: pre(x, generator=gen), 5)
    if tuple(lr_img.shape) != (bs, hr // scale, hr // scale, 3) or tuple(
            code.shape) != (bs, 11) or not (0 <= float(lr_img.min())
                                             and float(lr_img.max()) <= 1):
        raise AssertionError(f"[13e] SRMD {tuple(lr_img.shape)}")
    log(f"[13e] LRHR_seg_bg: {n} images of {side}² (+{n_bg} background), "
        f"an item {item_ms:.1f} ms in one process; the loader (4 workers, "
        f"batch {b}, enlarge ×4): {items} items in {secs:.2f} s = "
        f"{items / secs:.1f} items/s (worker start included); an SFT-GAN "
        f"step on its first batch: finite; SRMDPreprocessing batch {bs}, HR "
        f"{hr}², ×{scale}, l {l}, anisotropic, noise: {srmd_ms:.2f} ms a call")
    return {"item_ms": item_ms, "loader_items_per_s": items / secs,
            "loader_items": items, "srmd_ms": srmd_ms}


def p13_card_vs_cpu(torch, vgg):
    """13f: ESRGAN (RRDBNet, ragan, the VGG feature loss), the MSRResNet
    SRGAN with ``gan``, ``lsgan`` and ``wgan-gp`` (G + D steps) and SFT-GAN
    at step 20001 (every G parameter moves), at 13a–13c's batch and sizes
    (16, LR 32²; SFT-GAN 24²) with G's depth cut (``P13_CPU_NB``): a step on
    the card and on the CPU from the same seeded weights and batch — the
    pixel and feature losses ≤ ``P13_LOSS_REL`` relative; the logs
    computed from D's outputs (``P13_D_LOGS``: ``D_real`` / ``D_fake`` and
    the GAN terms, which under ``lsgan`` and ``wgan-gp`` are the logits'
    means or mean squares) ≤ ``P13_LOSS_REL`` relative or ``GRAD_NOISE``×
    their largest move under the four one-ulp nudges on either side;
    ``test``'s outputs ≤ ``P13_OUT_REL`` of max |ref|; the
    updated G and D weights and D's running statistics apart by no more
    than ``GRAD_NOISE``× the largest change either side's step makes under
    the nudges (norm over all, of the step's move); then
    ``SRMDPreprocessing`` and ``IsoGaussian`` on the same draws
    ≤ ``P13_DEG_REL`` of max |ref|. Every case is run and logged; any
    failure fails the phase. cuDNN's deterministic algorithms."""
    from endosr_torch.ops.degradation import (IsoGaussian, SRMDPreprocessing,
                                              pca_matrix, random_batch_kernel)

    cudnn = torch.backends.cudnn
    was = cudnn.deterministic
    cudnn.deterministic = True
    b, lr = P13_GAN
    d64 = {"which_model_D": "discriminator_vgg_128", "nf": 64}
    cases = {"esrgan ragan": (_gan13_opt(
        "srgan", {"which_model_G": "RRDBNet", "nf": 64,
                  "nb": P13_CPU_NB["RRDBNet"]},
        ESRGAN_TRAIN, lr, vgg, d64), lr, 1, False)}
    for gan_type in ("gan", "lsgan", "wgan-gp"):
        cases[f"srgan {gan_type}"] = (_gan13_opt(
            "srgan", {"which_model_G": "MSRResNet", "nf": 64,
                      "nb": P13_CPU_NB["MSRResNet"]},
            dict(ESRGAN_TRAIN, gan_type=gan_type), lr, None, d64), lr, 1,
            False)
    cases["sftgan"] = (_gan13_opt("sftgan", {"which_model_G": "sft_arch"},
                                  SFT_TRAIN, P13_SFT[1], vgg),
                       P13_SFT[1], 20001, True)
    gen = torch.Generator(device=DEV13).manual_seed(137)
    out, failed = {}, []
    try:
        for name, (opt, side, step, sft) in cases.items():
            t0 = time.perf_counter()
            batch = _gan13_batch(torch, gen, b, side, sft)
            lq_key = "LR" if sft else "LQ"
            runs = _cpu_twin(torch, opt, batch, lq_key, step,
                             ("netG", "netD"), _dev13())
            card, cpu = runs["card"], runs["cpu"]
            if any(not torch.equal(card["start"][k], v)
                   for k, v in cpu["start"].items()):
                raise AssertionError(f"[13f] {name}: the seeded weights "
                                     "differ")
            out_rel = max(float((a - c).abs().max())
                          / max(float(c.abs().max()), 1e-12)
                          for a, c in zip(card["out"], cpu["out"]))
            nudged = [(runs[f"{sd} {lab}"], runs[sd])
                      for sd in ("card", "cpu") for lab, *_ in P12_NUDGES]
            # each log as a share of its bar: P13_LOSS_REL relative; for
            # P13_D_LOGS also GRAD_NOISE× its move under the nudges
            rels, ratio = {}, {}
            for k, v in cpu["logs"].items():
                d = abs(card["logs"][k] - v)
                rels[k] = d / max(abs(v), 1e-12)
                bar = P13_LOSS_REL * abs(v)
                if k in P13_D_LOGS:
                    bar = max(bar, GRAD_NOISE * max(
                        abs(r["logs"][k] - base["logs"][k])
                        for r, base in nudged))
                ratio[k] = d / max(bar, 1e-30)
            worst = max(ratio, key=ratio.get)
            loss_rel = max(v for k, v in rels.items() if k not in P13_D_LOGS)
            d_rel = max(v for k, v in rels.items() if k in P13_D_LOGS)
            prel = _apart(card, cpu)
            prel_n = max(_apart(r, base) for r, base in nudged)
            srel = _apart(card, cpu, "stats", "stats0")
            srel_n = max(_apart(r, base, "stats", "stats0")
                         for r, base in nudged)
            fails = []
            if sorted(card["logs"]) != sorted(cpu["logs"]) or not (
                    ratio[worst] <= 1):
                fails.append(f"log {worst} {ratio[worst]:.3g} of its bar")
            if not out_rel <= P13_OUT_REL:
                fails.append(f"outputs {out_rel:.3g} of max |ref|")
            if not prel <= GRAD_NOISE * prel_n:
                fails.append(f"updated weights {prel:.3g} > {GRAD_NOISE}× "
                             f"{prel_n:.3g}")
            if not srel <= GRAD_NOISE * srel_n:
                fails.append(f"running statistics {srel:.3g} > "
                             f"{GRAD_NOISE}× {srel_n:.3g}")
            out[name] = {"loss_rel": loss_rel, "d_log_rel": d_rel,
                         "log_rels": rels,
                         "log_bar_ratio": ratio, "out_rel": out_rel,
                         "params_rel": prel, "params_rel_ulp": prel_n,
                         "stats_rel": srel, "stats_rel_ulp": srel_n,
                         "s": time.perf_counter() - t0}
            net = opt["network_G"]
            log(f"[13f] {name}, step {step}, batch {b}, LR {side}², G "
                f"{net['which_model_G']}" + (f" nb {net['nb']}" if "nb" in net
                                             else "")
                + f", card vs CPU: pixel and feature losses {loss_rel:.3g} "
                f"relative at most (tol {P13_LOSS_REL:g}), the logs from D's "
                f"outputs {d_rel:.3g}; each log relative and as a share of "
                f"its bar ({P13_LOSS_REL:g} relative; from D's outputs: or "
                f"{GRAD_NOISE}× their one-ulp nudges' move): " + ", ".join(f"{k} {rels[k]:.2g} ({ratio[k]:.2g})"
                                       for k in rels) + ";"
                f" outputs {out_rel:.3g} of max |ref| (tol {P13_OUT_REL:g}); "
                f"updated G and D weights {prel:.3g} of the move apart (the "
                f"largest under the one-ulp nudges on either side "
                f"{prel_n:.3g}, tol {GRAD_NOISE}× that); D's running "
                f"statistics {srel:.3g} (nudges {srel_n:.3g}); "
                f"{out[name]['s']:.1f} s"
                + (f" FAILED: {'; '.join(fails)}" if fails else ""))
            failed += [f"{name}: {f}" for f in fails]
            del runs
            if DEV13 == "cuda":
                torch.cuda.empty_cache()
        # the degradation pipelines on the same draws
        bs, hr, scale, l = P13_SRMD
        ks = random_batch_kernel(256, l, rate_iso=0.5,
                                 generator=torch.Generator().manual_seed(5))
        pca = pca_matrix(ks.numpy())
        x = torch.rand((bs, hr, hr, 3), generator=gen, device=DEV13)
        deg = {}
        for name, pre in (("srmd", SRMDPreprocessing(
                scale, pca, kernel=l, noise=True, rate_iso=0.5)),
                ("iso", IsoGaussian(scale, pca, kernel=l, noise=True,
                                    noise_high=0.05))):
            draws = pre.draws(x, gen)
            card = pre(x, draws=draws) if name == "iso" else pre(
                x, True, draws=draws)
            host = _on_cpu(torch, draws)
            cpu = pre(x.cpu(), draws=host) if name == "iso" else pre(
                x.cpu(), True, draws=host)
            deg[name] = max(float((a.cpu() - c).abs().max())
                            / max(float(c.abs().max()), 1e-12)
                            for a, c in zip(card, cpu))
            if not deg[name] <= P13_DEG_REL:
                failed.append(f"{name}: {deg[name]:.3g} of max |ref| > "
                              f"{P13_DEG_REL:g}")
        out["degradation"] = deg
        log(f"[13f] degradation, batch {bs}, HR {hr}², ×{scale}, l {l}, card "
            f"vs CPU on the same draws: SRMDPreprocessing {deg['srmd']:.3g}, "
            f"IsoGaussian {deg['iso']:.3g} of max |ref| (tol "
            f"{P13_DEG_REL:g})")
        if failed:
            raise AssertionError("[13f] " + "; ".join(failed))
    finally:
        cudnn.deterministic = was
    return out


def _on_cpu(torch, tree):
    """A nest of dicts of tensors, on the CPU."""
    if isinstance(tree, dict):
        return {k: _on_cpu(torch, v) for k, v in tree.items()}
    return tree.cpu()


def phase13(torch, counters):
    """Phase 13: the GAN models, their data and the degradation toolkit
    (13a–13f), fp32 with TF32 off, seeded weights (and a seeded VGG19
    file: the repo holds none), synthetic data under ``build/gan13``
    (deleted after). Returns ({path label: launches}, readings)."""
    import shutil

    from endosr_torch.models.sftgan_model import SFTGANACDModel
    from endosr_torch.models.srgan_model import SRGANModel
    from endosr_torch.utils.port_params import write_seeded_vgg

    root = Path(__file__).resolve().parent / GAN13_ROOT
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    vgg = write_seeded_vgg(str(root / "vgg19.pth"), seed=13)
    taps = ModelTaps(torch, counters, (SRGANModel, SFTGANACDModel))
    numbers = {}
    uninstall = taps.install()
    try:
        for key, fn in (("13a", lambda: p13_esrgan(torch, root, taps, vgg)),
                        ("13b", lambda: p13_srgan_losses(torch, taps)),
                        ("13c", lambda: p13_sftgan(torch, taps, vgg)),
                        ("13d", lambda: p13_requests(torch, taps)),
                        ("13e", lambda: p13_data(torch, root, taps))):
            t = time.perf_counter()
            numbers[key] = fn()
            numbers[key + "_s"] = time.perf_counter() - t
            log(f"[phase 13] {key}: {numbers[key + '_s']:.1f} s")
    finally:
        uninstall()
    launches = {label: {c.__name__: sum(r["launches"][c.__name__]
                                        for r in recs) for c in counters}
                for label, recs in taps.calls.items()}
    if DEV13 == "cuda":
        t = time.perf_counter()
        numbers["13f"] = p13_card_vs_cpu(torch, vgg)
        numbers["13f_s"] = time.perf_counter() - t
        log(f"[phase 13] 13f: {numbers['13f_s']:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    numbers["seconds"] = time.perf_counter() - t0
    log(f"[phase 13] took {numbers['seconds']:.1f} s")
    return launches, numbers


P14_ROOT = "build/p14"         # under the repository root, git-ignored
P14_STEPS = 3                  # timed steps after the compared first one
P14_SEED = 14
P14_ORDER = 4                  # 14b: × the 1-rank step's own change when its
#                                batch's halves swap, its weights move 1 ulp or
#                                its forward runs on a rank's share at a time
P14_FLOOR = 2e-4               # 14b: at least this (gradients, the update)
P14_X2_NET = "options/test/test_depthNet.yml"   # 14c's network_G fields
P14_X2_SMALL = (250, 186)      # 14c: LR of the compared frame (H, W % 16 ≠ 0)
P14_X2_BIG = (512, 512)        # 14c: LR of the memory reading
P14_X2_WORLD = 4
P14_X2_TOL = 1e-4              # 14c: sharded vs unsharded (JAX's bar)
P14_X2_WANT = {"style_dot_hwbm": 2, "output_stage": 1}
P14_TIMEOUT = 600              # seconds a spawned rank may take


def _kernel_counters():
    """The twelve kernel wrappers (their ``launches`` / ``routes``)."""
    from endosr_torch.kernels.fused_in_mod import fused_in_mod
    from endosr_torch.kernels.fused_mod import fused_modulation
    from endosr_torch.kernels.fused_obranch import fused_o_branch
    from endosr_torch.kernels.fused_tail import fused_tail
    from endosr_torch.kernels.head_dot import head_dot
    from endosr_torch.kernels.in_stats import in_stats
    from endosr_torch.kernels.output_stage import output_stage, output_stage_x8
    from endosr_torch.kernels.packed_chain import packed_g123
    from endosr_torch.kernels.shuffle_mid import mid_shuffle
    from endosr_torch.kernels.style_dot import style_blend_dot, style_dot_hwbm

    return [packed_g123, style_blend_dot, head_dot, output_stage_x8,
            output_stage, style_dot_hwbm, fused_in_mod, in_stats,
            fused_o_branch, fused_modulation, fused_tail, mid_shuffle]


def _p14_batch(torch):
    """The flagship's batch (phase 6a's layout): 8 seeded uint8 LQ 128² /
    GT 1024², depth and its K = 10 masks, on the card."""
    from endosr_torch.ops.masks import depth_masks

    gen = torch.Generator(device="cuda").manual_seed(P14_SEED)

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=gen, device="cuda",
                             dtype=torch.uint8)

    dep = torch.rand((8, 128, 128, 1), generator=gen, device="cuda")
    return {"LQ": u8(8, 128, 128, 3), "GT": u8(8, 1024, 1024, 3),
            "Depth": dep, "DepthMaskList": depth_masks(
                dep[..., 0], False, 10).to(torch.uint8)}


def _p14_model(torch, mesh=None):
    """The flagship bf16 training model (``models/recipes.py``) over
    ``mesh`` (None: the default one), as ``train.py`` builds it (with
    ``sync_replicas``); :func:`_p14_steps` resets it for every run."""
    from endosr_torch.models.f_depthcond import FModelDepthCond
    from endosr_torch.models.recipes import x8_train_opt

    m = FModelDepthCond(x8_train_opt("bf16"), mesh=mesh)
    m.sync_replicas()
    m.rng0 = copy.deepcopy(m._np_rng)
    return m


def _in_parts(torch, net, parts):
    """``net`` run on ``parts`` equal shares of its batch, one call each
    (as ``parts`` ranks run it), the outputs joined in the memory layout
    of the first."""
    def run(*args):
        k = args[0].shape[0] // parts
        outs = [net(*(a[i * k:(i + 1) * k] for a in args))
                for i in range(parts)]
        order = sorted(range(outs[0].dim()), key=lambda d: -outs[0].stride(d))
        joined = torch.cat([o.permute(order) for o in outs], order.index(0))
        return joined.permute([order.index(d) for d in range(len(order))])

    return run


def _p14_steps(torch, m, start, batch, counters, steps, parts=1):
    """``steps`` flagship bf16 steps of the model ``m`` from the
    parameters ``start`` (a fresh Adam, the mask loss's RNG from its
    seed) on ``batch``, cuDNN's deterministic algorithms,
    the counts set to 0 just before and read just after: {logs a step,
    step 1's gradients, the parameters after step 1 and after the last,
    ms a step after the first, launches, routes}. ``parts``: the network
    runs on that many shares of the batch, one call each (the losses on
    the whole batch)."""
    cudnn = torch.backends.cudnn
    was, cudnn.deterministic = cudnn.deterministic, True
    net = m._train_net
    if parts > 1:
        m._train_net = _in_parts(torch, net, parts)
    try:
        m.step = 0
        m._np_rng = copy.deepcopy(m.rng0)
        m.optimizer_G.state.clear()
        with torch.no_grad():
            for k, p in m.named_train_parameters():
                p.copy_(start[k])
        m.feed_data(batch)
        torch.cuda.synchronize()
        zero_counts(counters)
        out = {"logs": [], "secs": []}
        for n in range(steps):
            t = time.perf_counter()
            out["logs"].append(dict(m.optimize_parameters(n)))
            torch.cuda.synchronize()
            out["secs"].append(time.perf_counter() - t)
            if n == 0:
                out["grads"] = _grads(m)
                out["params1"] = {k: p.detach().cpu() for k, p
                                  in m.named_train_parameters()}
        out["params"] = {k: p.detach().cpu() for k, p
                         in m.named_train_parameters()}
        out["launches"] = {c.__name__: c.launches for c in counters}
        out["routes"] = {c.__name__: dict(c.routes) for c in counters
                         if hasattr(c, "routes")}
        out["ms"] = (sum(out["secs"][1:]) / max(1, steps - 1) * 1e3
                     if steps > 1 else float("nan"))
    finally:
        cudnn.deterministic = was
        m._train_net = net
        m.batch = {}
        torch.cuda.empty_cache()
    return out


def _check_train_launches(label, run, steps):
    for name, n in run["launches"].items():
        want = TRAIN_WANT.get(name, 0) * steps
        if n != want:
            raise AssertionError(f"[{label}] {name}: {n} launches in {steps} "
                                 f"steps, want {want}")


def _bit_equal(a, b):
    import torch

    return all(torch.equal(a[k], b[k]) for k in a) and sorted(a) == sorted(b)


def _p14_launch(job, world, where, payload, backend="gloo"):
    """Run ``python3 chip_smoke.py --p14-rank <job> <where>`` on ``world``
    ranks (torchrun's environment; ``cuda:rank`` modulo the cards present,
    over ``backend``) with ``payload``; returns each rank's exit code
    ("timeout" for a rank killed at ``P14_TIMEOUT``), the tail of the log
    of each rank that failed logged."""
    import os
    import socket

    import torch

    where.mkdir(parents=True, exist_ok=True)
    torch.save(payload, where / "in.pt")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        env = {**os.environ, "RANK": str(r), "LOCAL_RANK": str(r),
               "WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "P14_BACKEND": backend}
        logf = open(where / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--p14-rank", job,
             str(where)], env=env, stdout=logf, stderr=subprocess.STDOUT,
            cwd=str(Path(__file__).resolve().parent)), logf))
    codes = []
    try:
        deadline = time.perf_counter() + P14_TIMEOUT
        for p, _ in procs:
            try:
                codes.append(p.wait(timeout=max(1.0, deadline
                                                - time.perf_counter())))
            except subprocess.TimeoutExpired:
                codes.append("timeout")
    finally:
        for p, logf in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            logf.close()
    for r, code in enumerate(codes):
        if code != 0:
            for line in (where / f"rank{r}.log").read_text().splitlines()[-40:]:
                log(f"  rank {r} (exit {code}): {line}")
    return codes


def _p14_spawn(job, world, where, payload, backend="gloo"):
    """:func:`_p14_launch`; returns each rank's result, and raises unless
    every rank exited with 0."""
    import torch

    codes = _p14_launch(job, world, where, payload, backend)
    if any(c != 0 for c in codes):
        raise AssertionError(f"[phase 14] {job}: rank exit codes {codes}")
    return [torch.load(where / f"out{r}.pt", weights_only=False)
            for r in range(world)]


GLOO_PROBES = ("all_reduce", "broadcast", "barrier", "all_gather",
               "all_gather_into_tensor", "reduce", "reduce_scatter_tensor",
               "all_to_all_single", "gather", "scatter", "send/recv")


def _gloo_probe(torch, where):
    """(``python3 chip_smoke.py --gloo-probe``, not part of the default
    run; a rank aborts in it.) Which collectives gloo carries for CUDA
    tensors here: each one
    called on a small CUDA tensor by every rank alike, in a group of its
    own with a 30 s timeout; ``<where>/probe<rank>.json`` gets "ok" or the
    error of each before the next starts (one that kills the process is
    the last one started)."""
    import datetime

    import torch.distributed as dist

    r, n = dist.get_rank(), dist.get_world_size()
    group = dist.new_group(backend="gloo",
                           timeout=datetime.timedelta(seconds=30))
    dev = torch.device("cuda", torch.cuda.current_device())
    t = torch.full((4,), float(r + 1), device=dev)
    kw = {"group": group}
    calls = {
        "all_reduce": lambda: dist.all_reduce(t.clone(), **kw),
        "broadcast": lambda: dist.broadcast(t.clone(), 0, **kw),
        "barrier": lambda: dist.barrier(**kw),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(t) for _ in range(n)], t, **kw),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * n, device=dev), t, **kw),
        "reduce": lambda: dist.reduce(t.clone(), 0, **kw),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev), torch.ones(4 * n, device=dev), **kw),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(4 * n, device=dev), torch.ones(4 * n, device=dev),
            **kw),
        "gather": lambda: dist.gather(
            t, [torch.empty_like(t) for _ in range(n)] if r == 0 else None,
            0, **kw),
        "scatter": lambda: dist.scatter(
            torch.empty_like(t),
            [t.clone() for _ in range(n)] if r == 0 else None, 0, **kw),
        "send/recv": lambda: (dist.send(t, 1, **kw) if r == 0 else
                              dist.recv(torch.empty_like(t), 0, **kw)
                              if r == 1 else None),
    }
    out = {}
    path = Path(where) / f"probe{r}.json"
    for name in GLOO_PROBES:
        out[name] = "started"
        path.write_text(json.dumps(out))
        try:
            calls[name]()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:         # the probe's reading, not a check
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
        path.write_text(json.dumps(out))
    return out


def _probe_readings(where, codes):
    """The gloo probe's readings of the ranks (``probe<rank>.json``): an
    op still "started" in a rank that exited with an error killed it."""
    out = {}
    for r, code in enumerate(codes):
        path = where / f"probe{r}.json"
        got = json.loads(path.read_text()) if path.exists() else {}
        for name in GLOO_PROBES:
            v = got.get(name, "not reached")
            if v == "started":
                v = f"the rank exited with {code} in it"
            if out.get(name, "ok") == "ok":
                out[name] = v
    return out


def _p14_rank(torch, job, where):
    """A spawned rank of 14b (``dp``), 14c (``spatial``) or the gloo probe
    (``probe``): the process group from torchrun's environment over gloo
    on this card; writes its readings to ``<where>/out<rank>.pt``."""
    import torch.distributed as dist

    from endosr_torch.parallel.mesh import get_mesh, maybe_init_distributed
    from endosr_torch.utils.device import local_device

    import os

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    where = Path(where)
    backend = os.environ.get("P14_BACKEND", "gloo")
    maybe_init_distributed(backend=backend, device=local_device(),
                           timeout_s=P14_TIMEOUT)
    if job == "probe":
        _gloo_probe(torch, where)
        dist.barrier()
        dist.destroy_process_group()
        return 0
    payload = torch.load(where / "in.pt", weights_only=False)
    counters = _kernel_counters()
    tap = KernelTap()
    uninstall = tap.install()
    tap.where = job
    try:
        if job == "dp":
            from endosr_torch.parallel.mesh import shard_batch

            mesh = get_mesh()
            batch = shard_batch({k: v.cuda() for k, v in
                                 payload["batch"].items()}, mesh)
            out = _p14_steps(torch, _p14_model(torch), payload["start"],
                             batch, counters, 1 + P14_STEPS)
        else:
            out = _p14_spatial_rank(torch, payload, counters)
    finally:
        uninstall()
    out["calls"] = tap.calls
    out["gpu"] = gpu_line()
    torch.save(out, where / f"out{dist.get_rank()}.pt")
    dist.barrier()          # no rank leaves while another still talks to it
    dist.destroy_process_group()
    return 0


def _x2_serving_opt(spatial=0):
    """14c's model: the test YAML's ``network_G`` at ×2, fp32, bucketed
    (unset: 32), K 10; ``spatial_shard`` ``spatial``."""
    import yaml

    net = yaml.safe_load((Path(__file__).resolve().parent / P14_X2_NET)
                         .read_text())["network_G"]
    net.pop("upscale", None)
    return {"is_train": False, "model": "sftmd_depthCond", "scale": 2,
            "precision": None, "spatial_shard": spatial,
            "datasets": {"test": {"phase": "test", "depthMaskNum": 10,
                                  "LR_size": 128}},
            "network_G": net, "path": {}}


def _x2_frame(torch, hw, seed):
    """One seeded frame: LQ, depth and its K = 10 depth masks, on the
    host (numpy), batch 1."""
    import numpy as np

    from endosr_torch.ops.masks import depth_masks_np

    rng = np.random.default_rng(seed)
    dep = rng.random(hw).astype(np.float32)
    return {"LQ": rng.random((1, *hw, 3), dtype=np.float32),
            "Depth": dep[None, ..., None],
            "DepthMaskList": depth_masks_np(dep, False, 10)[None].astype(
                np.float32)}


def _serve_once(torch, model, batch, counters):
    """(SR on the host, ms, peak GiB, launches) of one ``test`` on
    ``batch``, the counts set to 0 just before and read just after."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model.feed_data(batch)
    zero_counts(counters)
    t = time.perf_counter()
    sr = model.test()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    return (sr.cpu(), ms, torch.cuda.max_memory_allocated() / 2 ** 30,
            {c.__name__: c.launches for c in counters},
            {c.__name__: dict(c.routes) for c in counters
             if hasattr(c, "routes")})


def _p14_spatial_rank(torch, payload, counters):
    from endosr_torch.models.f_depthcond import FModelDepthCond

    model = FModelDepthCond(_x2_serving_opt(payload["world"]))
    model.netG.load_state_dict(payload["state"])
    out = {}
    for key in ("small", "big"):
        sr, ms, peak, launches, routes = _serve_once(
            torch, model, payload[key], counters)
        if key == "small":
            out["max_abs"] = float((sr - payload["want"]).abs().max())
            out["shape"] = tuple(sr.shape)
        out[key] = {"ms": ms, "peak_gib": peak, "launches": launches,
                    "routes": routes, "finite": bool(sr.isfinite().all())}
    return out


def _merge_calls(calls, *more):
    """``KernelTap`` records of several processes, summed into ``calls``."""
    for extra in more:
        for key, rec in extra.items():
            mine = calls.setdefault(key, {"grad": False, "where": {}})
            mine["grad"] |= rec["grad"]
            for w, n in rec["where"].items():
                mine["where"][w] = mine["where"].get(w, 0) + n
    return calls


def _p14_reference(torch, counters, world):
    """The flagship's 1-rank step (``1 + P14_STEPS`` steps) on
    :func:`_p14_batch` from the seeded weights, and the yardstick runs of
    14b's rule: the step with the batch's halves swapped (every sum over
    the batch in another order), from the weights nudged one ulp (phase
    6b's nudges), and with the network run on each of ``world`` shares of
    the batch in turn (the shapes, so the cuDNN algorithms and the kernels'
    tilings, of a rank; the losses on the whole batch). Returns (start,
    batch, the step, the first two yardsticks, the last)."""
    model = _p14_model(torch)
    start = {k: p.detach().clone() for k, p in model.named_train_parameters()}
    batch = _p14_batch(torch)
    single = _p14_steps(torch, model, start, batch, counters, 1 + P14_STEPS)
    _check_train_launches("14a single", single, 1 + P14_STEPS)
    others = [_p14_steps(torch, model, start, {
        k: torch.cat([v[4:], v[:4]]) for k, v in batch.items()}, counters, 1)]
    others += [_p14_steps(torch, model, _nudge_weights(torch, start, seed),
                          batch, counters, 1) for seed in (1, 2)]
    parts = _p14_steps(torch, model, start, batch, counters, 1, world)
    del model
    torch.cuda.empty_cache()
    return start, batch, single, others, parts


def p14_dp(torch, counters, root):
    """14a and 14b: the flagship ×8 step (bf16, batch 8, LQ 128² → GT
    1024², the YAML's ``dynamic_loss`` on) through the distributed path.
    Returns (launches by path, readings, the ranks' kernel calls)."""
    import socket

    import torch.distributed as dist

    from endosr_torch.parallel.mesh import make_mesh

    numbers, launches = {}, {}
    start, batch, single, others, parts = _p14_reference(torch, counters, 2)

    # 14a: a process group of one rank over NCCL
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        model = _p14_model(torch, make_mesh())
        dp1 = _p14_steps(torch, model, start, batch, counters, 1 + P14_STEPS)
        del model
    finally:
        dist.destroy_process_group()
    _check_train_launches("14a dp world 1", dp1, 1 + P14_STEPS)
    launches["14a dp world 1"] = dp1["launches"]
    torch.cuda.empty_cache()
    same = {"logs": dp1["logs"] == single["logs"],
            "grads": _bit_equal(dp1["grads"], single["grads"]),
            "params1": _bit_equal(dp1["params1"], single["params1"]),
            "params": _bit_equal(dp1["params"], single["params"])}
    numbers["14a"] = {"bit_equal": same, "ms_single": single["ms"],
                      "ms_dp_world1": dp1["ms"],
                      "l_all": [lg["l_all"] for lg in dp1["logs"]]}
    log(f"[14a] flagship bf16 step, batch 8, through a 1-rank NCCL group: "
        f"{dp1['ms']:.1f} ms a step against {single['ms']:.1f} single-device "
        f"(mean of steps 2–{1 + P14_STEPS}, cuDNN deterministic, host clock, "
        f"synchronised); bit-equal to the single-device step: {same}; "
        f"launches {dp1['launches']}; {gpu_line()}")
    if not all(same.values()):
        raise AssertionError(f"[14a] the 1-rank step is not the single-device "
                             f"step bit for bit: {same}")
    got, numbers["14b"], calls = p14_dp_ranks(
        torch, root, start, batch, single, others, parts, 2, "gloo", "14b")
    launches["14b dp world 2"] = got
    return launches, numbers, calls


def p14_dp_ranks(torch, root, start, batch, single, others, parts, world,
                 backend, tag):
    """The flagship step on ``world`` spawned ranks over ``backend``, each
    on its ``8 // world`` images of ``batch``, against the 1-rank step
    ``single`` by 14b's rule (the yardsticks ``others`` and ``parts``).
    Returns (the ranks' launches summed, readings, the ranks' kernel
    calls).

    The rule: the loss, all gradients together and the first update
    within ``P14_ORDER`` × the largest change of the 1-rank step under the
    yardsticks ``others`` (halves swapped, one-ulp nudges), or
    ``P14_FLOOR``; each gradient tensor within ``P14_ORDER`` × the largest
    of those and of ``parts`` (the 1-rank step with the network run on
    each rank's share in turn, which measures what a rank's smaller
    shapes change) + ``P14_FLOOR``, and within ``P14_ORDER`` × the first
    + ``P14_FLOOR`` of ``parts`` itself, which runs the ranks' shapes in
    one process (a depth block's conv biases, whose true gradient is zero
    under the InstanceNorm after them, are read but not held)."""
    ranks = _p14_spawn("dp", world, root / f"dp{world}{backend}", {
        "start": start, "batch": {k: v.cpu() for k, v in batch.items()}},
        backend)
    for r, out in enumerate(ranks):
        _check_train_launches(f"{tag} rank {r}", out, 1 + P14_STEPS)
    r0 = ranks[0]
    equal_ranks = all(_bit_equal(r0[k], o[k]) for o in ranks[1:]
                      for k in ("params1", "params"))
    ref = single["logs"][0]["l_all"]
    loss = abs(r0["logs"][0]["l_all"] - ref)
    loss_order = max(abs(o["logs"][0]["l_all"] - ref) for o in others)
    worst, fails = [], []
    for k, w in single["grads"].items():
        got = _nrel({k: r0["grads"][k]}, {k: w})
        order = max(_nrel({k: o["grads"][k]}, {k: w}) for o in others)
        shares = _nrel({k: parts["grads"][k]}, {k: w})
        bar = P14_ORDER * max(order, shares) + P14_FLOOR
        vs_parts = _nrel({k: r0["grads"][k]}, {k: parts["grads"][k]})
        bar_parts = P14_ORDER * order + P14_FLOOR
        worst.append((got / bar, k, got, order, shares, vs_parts))
        if _before_instance_norm(k):
            continue
        if got > bar:
            fails.append(f"{k} {got:.3g} > {bar:.3g}")
        if vs_parts > bar_parts:
            fails.append(f"{k} against the in-shares step {vs_parts:.3g} > "
                         f"{bar_parts:.3g}")
    all_got = _nrel(r0["grads"], single["grads"])
    all_order = max(_nrel(o["grads"], single["grads"]) for o in others)
    all_shares = _nrel(parts["grads"], single["grads"])
    all_vs_parts = _nrel(r0["grads"], parts["grads"])
    move = {k: single["params1"][k] - start[k].cpu() for k in start}

    def update_apart(run):
        """‖run's first update − the 1-rank step's‖ / ‖the latter‖."""
        return _nrel({k: run["params1"][k] - start[k].cpu() for k in start},
                     move)

    p_got = update_apart(r0)
    p_order = max(update_apart(o) for o in others)
    numbers = {
        "world": world, "backend": backend,
        "ranks_bit_equal": equal_ranks, "loss_abs": loss,
        "loss_order_abs": loss_order, "grad_nrel_all": all_got,
        "grad_nrel_all_order": all_order, "grad_nrel_all_shares": all_shares,
        "grad_nrel_all_vs_shares": all_vs_parts, "update_nrel": p_got,
        "update_nrel_order": p_order, "ms": [o["ms"] for o in ranks],
        "worst": [dict(zip(("tensor", "nrel", "order", "shares",
                            "vs_shares"), w[1:]))
                  for w in sorted(worst)[-4:]],
        "gpus": sorted({o["gpu"] for o in ranks})}
    log(f"[{tag}] {world} ranks over {backend}, {8 // world} images each, "
        f"against the 1-rank step on the 8: l_all |Δ| {loss:.3g} (the "
        f"1-rank step with its halves swapped or its weights nudged one ulp, "
        f"the largest: {loss_order:.3g}); gradients {all_got:.3g} "
        f"norm-relative ({all_order:.3g}; the 1-rank step with the network "
        f"on one rank's share at a time: {all_shares:.3g}, the ranks against "
        f"it {all_vs_parts:.3g}); the update {p_got:.3g} of its "
        f"move ({p_order:.3g}); ranks bit-equal {equal_ranks}; "
        f"{[round(o['ms'], 1) for o in ranks]} ms a step (steps 2–"
        f"{1 + P14_STEPS}); worst tensors (ranks, yardstick, in shares, "
        f"ranks against in shares) "
        + ", ".join(f"{k} {g:.3g} ({o:.3g}, {sh:.3g}, {vp:.3g})"
                    for _, k, g, o, sh, vp in sorted(worst)[-3:])
        + f"; {r0['gpu']}")
    bars = {"ranks": equal_ranks,
            "loss": loss <= P14_ORDER * loss_order + 1e-6 * abs(ref),
            "grads_all": all_got <= max(P14_FLOOR, P14_ORDER * all_order),
            "update": p_got <= max(P14_FLOOR, P14_ORDER * p_order),
            "tensors": not fails}
    if not all(bars.values()):
        raise AssertionError(f"[{tag}] world {world} against world 1: "
                             f"{bars}; " + "; ".join(fails[:5]))
    launches = {k: sum(o["launches"][k] for o in ranks)
                for k in r0["launches"]}
    return launches, numbers, _merge_calls({}, *(o["calls"] for o in ranks))


def p14_spatial(torch, counters, root, world=P14_X2_WORLD, backend="gloo",
                tag="14c"):
    """14c: ×2 fp32 serving at full width split over ``world`` ranks
    (spawned, over ``backend``), against the unsharded masked forward.
    Returns (the ranks' launches summed, readings, their kernel calls)."""
    from endosr_torch.models.f_depthcond import FModelDepthCond
    from endosr_torch.utils.port_params import seeded_init

    model = FModelDepthCond(_x2_serving_opt())
    seeded_init(model.netG, P14_SEED)
    state = {k: v.cpu() for k, v in model.netG.state_dict().items()}
    small = _x2_frame(torch, P14_X2_SMALL, 1)
    big = _x2_frame(torch, P14_X2_BIG, 2)
    want, ms, peak_small, launches_small, _ = _serve_once(
        torch, model, small, counters)
    _, ms_big, peak_big, _, _ = _serve_once(torch, model, big, counters)
    del model
    torch.cuda.empty_cache()
    ranks = _p14_spawn("spatial", world, root / f"sp{world}{backend}", {
        "state": state, "small": small, "big": big, "want": want,
        "world": world}, backend)
    for r, out in enumerate(ranks):
        for key in ("small", "big"):
            got = out[key]["launches"]
            want_n = {k: P14_X2_WANT.get(k, 0) for k in got}
            if got != want_n or not out[key]["finite"]:
                raise AssertionError(f"[{tag}] rank {r} {key}: launches "
                                     f"{got}, want {want_n}; finite "
                                     f"{out[key]['finite']}")
        if out["shape"] != tuple(want.shape) or not out["max_abs"] <= P14_X2_TOL:
            raise AssertionError(f"[{tag}] rank {r}: SR {out['shape']} max "
                                 f"|Δ| {out['max_abs']:.3g} against the "
                                 f"unsharded {tuple(want.shape)} (bar "
                                 f"{P14_X2_TOL})")
    numbers = {
        "world": world, "backend": backend,
        "max_abs": max(o["max_abs"] for o in ranks),
        "small_lr": P14_X2_SMALL, "big_lr": P14_X2_BIG,
        "unsharded": {"ms_small": ms, "peak_small_gib": peak_small,
                      "ms_big": ms_big, "peak_big_gib": peak_big},
        "ranks": [{"ms_small": o["small"]["ms"], "ms_big": o["big"]["ms"],
                   "peak_small_gib": o["small"]["peak_gib"],
                   "peak_big_gib": o["big"]["peak_gib"]} for o in ranks]}
    log(f"[{tag}] ×2 fp32 full width (nb 16, latent 256, K 10), "
        f"{world} ranks over {backend}: LR "
        f"{P14_X2_SMALL[0]}×{P14_X2_SMALL[1]} SR max |Δ| "
        f"{numbers['max_abs']:.3g} against the unsharded masked forward "
        f"(bar {P14_X2_TOL}); LR {P14_X2_BIG[0]}²: peak "
        + ", ".join(f"{o['peak_big_gib']:.2f}" for o in numbers["ranks"])
        + f" GiB a rank against {peak_big:.2f} unsharded; ms a request "
        + ", ".join(f"{o['ms_big']:.1f}" for o in numbers["ranks"])
        + f" against {ms_big:.1f} unsharded; launches a rank "
        f"{ranks[0]['small']['launches']}; {ranks[0]['gpu']}")
    launches = {
        k: sum(o[key]["launches"][k] for o in ranks for key in ("small", "big"))
        for k in ranks[0]["small"]["launches"]}
    return launches, numbers, _merge_calls({}, *(o["calls"] for o in ranks))


def phase14(torch, counters):
    """Phase 14: data-parallel training (14a: a 1-rank NCCL group, bit for
    bit the single-device step; 14b: 2 ranks sharing the card over gloo)
    and H-sharded ×2 serving (14c: 4 ranks over gloo), then every kernel
    call of the phase again at its shape against its plain version.
    Returns ({path label: launches}, readings)."""
    import shutil

    root = Path(__file__).resolve().parent / P14_ROOT
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    tap = KernelTap()
    uninstall = tap.install()
    tap.where = "14a"
    try:
        launches, numbers, calls_b = p14_dp(torch, counters, root)
    finally:
        uninstall()
    numbers["dp_s"] = time.perf_counter() - t0
    t = time.perf_counter()
    launches["14c spatial x2"], numbers["14c"], calls_c = p14_spatial(
        torch, counters, root)
    numbers["spatial_s"] = time.perf_counter() - t
    calls = _merge_calls(dict(tap.calls), calls_b, calls_c)
    t = time.perf_counter()
    numbers["kernel_max_abs_err"], numbers["kernels"] = phase9_kernel_checks(
        torch, calls, "phase 14 kernels", controls=False)
    numbers["kernels_s"] = time.perf_counter() - t
    shutil.rmtree(root, ignore_errors=True)
    numbers["seconds"] = time.perf_counter() - t0
    log(f"[phase 14] took {numbers['seconds']:.1f} s (dp {numbers['dp_s']:.1f}, "
        f"spatial {numbers['spatial_s']:.1f}, kernel calls "
        f"{numbers['kernels_s']:.1f})")
    return launches, numbers


def p14_multi(torch, world):
    """``python3 chip_smoke.py --p14-nccl N`` (a call on N cards, not part
    of the one-card run): 14b's and 14c's checks with one rank a card over
    NCCL (the flagship step at ``8 // N`` images a rank against the 1-rank
    step by 14b's rule; ×2 serving split over N ranks against the
    unsharded forward), the references on card 0, then the ranks' kernel
    calls against their plain versions. Returns the readings."""
    import shutil

    root = Path(__file__).resolve().parent / P14_ROOT
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    counters = _kernel_counters()
    start, batch, single, others, parts = _p14_reference(torch, counters,
                                                         world)
    numbers = {"cards": torch.cuda.device_count(), "single_ms": single["ms"]}
    dp_launches, numbers["dp"], calls_d = p14_dp_ranks(
        torch, root, start, batch, single, others, parts, world, "nccl",
        "14b nccl")
    sp_launches, numbers["spatial"], calls_s = p14_spatial(
        torch, counters, root, world, "nccl", "14c nccl")
    numbers["launches"] = {"dp": dp_launches, "spatial": sp_launches}
    numbers["kernel_max_abs_err"], _ = phase9_kernel_checks(
        torch, _merge_calls({}, calls_d, calls_s), "phase 14 nccl kernels",
        controls=False)
    shutil.rmtree(root, ignore_errors=True)
    numbers["seconds"] = time.perf_counter() - t0
    log(f"[phase 14 nccl] took {numbers['seconds']:.1f} s")
    return numbers


def gloo_probe(world=2):
    """``python3 chip_smoke.py --gloo-probe``: :func:`_gloo_probe` on
    ``world`` ranks sharing this card; returns {collective: its reading}."""
    import shutil

    where = Path(__file__).resolve().parent / P14_ROOT / "probe"
    shutil.rmtree(where, ignore_errors=True)
    readings = _probe_readings(where, _p14_launch("probe", world, where, {}))
    shutil.rmtree(where, ignore_errors=True)
    return readings


P15_ROOT = "build/p15"         # under the repository root, git-ignored
P15_LR = {"train": (128, 128), "test": (128, 128)}
FIXTURE = "tests/data/jax_ckpt"      # written by tests/make_jax_ckpt_fixture.py
FIXTURE_REL = 2e-4                   # the repo's parity bar, of max |JAX out|
FLAGSHIP4 = ("packed_g123", "style_blend_dot", "head_dot", "output_stage_x8")


def _fixture_batch(np, seed, k=4, lr=8, b=2, scale=8):
    """``tests/make_jax_ckpt_fixture.py::batch``: a seeded training batch."""
    rng = np.random.default_rng(seed)
    return {"LQ": rng.random((b, lr, lr, 3), dtype=np.float32),
            "GT": rng.random((b, lr * scale, lr * scale, 3), dtype=np.float32),
            "Depth": rng.random((b, lr, lr, 1), dtype=np.float32),
            "DepthMaskList": (rng.random((b, lr, lr, k)) > 0.6).astype(
                np.float32)}


def _flax_file_equal(a, b, keys=None):
    """Two flax msgpack files hold the same tree (with ``keys``, those of
    its top level), bit for bit."""
    from endosr_torch.utils.msgpack_io import unpackb

    def eq(x, y):
        if isinstance(x, dict):
            return isinstance(y, dict) and x.keys() == y.keys() and all(
                eq(x[k], y[k]) for k in x)
        import numpy as np

        return (np.asarray(x).dtype == np.asarray(y).dtype
                and np.asarray(x).tobytes() == np.asarray(y).tobytes())

    ta, tb = (unpackb(Path(p).read_bytes()) for p in (a, b))
    if keys:
        ta, tb = ({k: t[k] for k in keys} for t in (ta, tb))
    return eq(ta, tb)


def p15_fixture(torch, counters):
    """15d: the JAX-written fixture read on the card: ``2_G.ckpt``'s fp32
    forward against JAX's stored output, and ``2.state`` resumed and
    stepped. Returns (launches, readings)."""
    import numpy as np

    from endosr_torch.models import create_model

    fx = Path(__file__).resolve().parent / FIXTURE
    opt = json.loads((fx / "opt.json").read_text())
    serve = copy.deepcopy(opt)
    serve.update(is_train=False,
                 path={"pretrain_model_G": str(fx / "2_G.ckpt")})
    model = create_model(serve)
    with np.load(fx / "input.npz") as z:
        inputs = [torch.from_numpy(z[k]).cuda()
                  for k in ("LQ", "Depth", "DepthMaskList")]
    torch.cuda.synchronize()
    zero_counts(counters)
    with torch.inference_mode():
        out = model.netG(*inputs)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    ref = torch.from_numpy(np.load(fx / "output.npy")).double()
    err = float((out.double().cpu() - ref).abs().max() / ref.abs().max())
    log(f"[15d] the JAX-written 2_G.ckpt (fixture {FIXTURE}, ×8 DepthNet, "
        f"fp32, LR 8×12, batch 2) on the card: max |Δ| / max |JAX out| "
        f"{err:.3e} (tol {FIXTURE_REL:g}); launches {launches}")
    if not (tuple(out.shape) == tuple(ref.shape) and bool(
            torch.isfinite(out).all()) and err <= FIXTURE_REL):
        raise AssertionError(f"[15d] fixture forward {tuple(out.shape)}, rel "
                             f"err {err}")
    trained = create_model(copy.deepcopy(opt))
    epoch_it = trained.resume_training(str(fx / "2.state"))
    same = all(torch.equal(v, model.netG.state_dict()[k])
               for k, v in trained.netG.state_dict().items())
    steps = {int(st["step"]) for st in trained.optimizer_G.state.values()}
    trained.feed_data(_fixture_batch(np, 3))
    logs = trained.optimize_parameters(3)
    log(f"[15d] the JAX-written 2.state resumed on the card: (epoch, iter) "
        f"{epoch_it}, weights equal to 2_G.ckpt's {same}, Adam counts "
        f"{steps}; step 3 l_all {logs['l_all']:.6g}")
    if (epoch_it != (0, 2) or not same or steps != {2} or trained.step != 3
            or not math.isfinite(logs["l_all"])):
        raise AssertionError(f"[15d] resume of 2.state: {epoch_it}, {same}, "
                             f"{steps}, {trained.step}, {logs}")
    return launches, {"fixture_rel_err": err, "resumed_l_all": logs["l_all"]}


def phase15(torch, counters):
    """Phase 15: JAX's checkpoint files in the port on the card. (a)
    ``train.main`` on the ×8 YAML (phase 7's changes, batches in order,
    no flips, no loader workers, ``checkpoint_backend: msgpack``, 4 steps,
    saving at 2); (b)
    a run resumed from its JAX-format ``2.state``: steps 3–4 (the same
    batches, as the loader does not shuffle) bit-equal to (a)'s, cuDNN
    deterministic (in (a) and (b) only); (c) ``test.main`` from ``4_G.ckpt``, unbucketed, where
    the four flagship kernels launch: the SR bit-equal to the same model
    served with (a)'s in-memory weights; (d) :func:`p15_fixture`.
    Returns ({path label: launches}, readings)."""
    import shutil

    import endosr_torch.test as entry_test
    import endosr_torch.train as entry_train

    repo = Path(__file__).resolve().parent
    root = repo / P15_ROOT
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_kvasir(root / "data", lr_hw=P15_LR)

    def roots(split):
        return {"dataroot_GT": str(root / "data/HR" / split),
                "dataroot_LQ": str(root / "data/LR" / split),
                "dataroot_depthMap": str(root / "data/depth" / split)}

    train_yaml = _derive(
        repo / "options/train/train_depthNet_SEAN_depthMask_x8.yml",
        root / "train.yml", {
            **{f"datasets.train.{k}": v for k, v in roots("train").items()},
            **{f"datasets.val.{k}": v for k, v in roots("test").items()},
            "datasets.train.data_num": 16, "datasets.train.use_shuffle": False,
            "datasets.train.use_flip": False, "datasets.train.use_rot": False,
            "datasets.train.n_workers": 0,
            "path.root": str(root / "run"),
            "path.checkpoint_backend": "msgpack", "train.niter": 4,
            "train.val_freq": 1000, "logger.save_checkpoint_freq": 2,
            "logger.print_freq": 1}, "15a")
    resume_yaml = _derive(root / "train.yml", root / "resume.yml", {
        "path.root": str(root / "resumed"), "path.resume_state": "auto"},
        "15b")
    run = root / "run" / EXP
    test_yaml = _derive(repo / "options/test/test_depthNet.yml",
                        root / "test.yml", {
                            **{f"datasets.test_1.{k}": v
                               for k, v in roots("test").items()},
                            "path.root": str(root / "eval"),
                            "path.pretrain_model_G": str(run / "models/4_G.ckpt"),
                            "eval_bucket_multiple": 0}, "15c")
    taps = EntryTaps(torch, counters)
    uninstall = taps.install()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    secs = {"data": time.perf_counter() - t0}
    try:
        taps.training = "15a train"
        t = time.perf_counter()
        model = entry_train.main(["-opt_F", train_yaml])
        secs["15a"] = time.perf_counter() - t
        shutil.copytree(root / "run", root / "resumed", ignore=lambda d, names: [
            n for n in names if n.startswith(("4", "latest"))])
        taps.training = "15b resumed"
        t = time.perf_counter()
        entry_train.main(["-opt_F", resume_yaml])
        secs["15b"] = time.perf_counter() - t
        torch.backends.cudnn.deterministic = det
        taps.serving = "15c eval"
        t = time.perf_counter()
        eval_model = entry_test.main(["-opt_F", test_yaml])
        # the same model with (a)'s weights from memory, on the same images
        eval_model.netG.load_state_dict(model.netG.state_dict())
        from endosr_torch.data import create_dataloader, create_dataset

        ds_opt = eval_model.opt["datasets"]["test_1"]
        taps.serving = "15c in memory"
        for batch in create_dataloader(create_dataset(ds_opt), ds_opt):
            eval_model.feed_data(batch)
            eval_model.test()
        secs["15c"] = time.perf_counter() - t
        del eval_model, model
    finally:
        torch.backends.cudnn.deterministic = det
        uninstall()
    torch.cuda.empty_cache()
    first, resumed = taps.calls["15a train"], taps.calls["15b resumed"]
    if (len(first), len(resumed)) != (4, 2):
        raise AssertionError(f"[15b] {len(first)} + {len(resumed)} steps")
    taps.check("15a train", first + resumed, TRAIN_WANT, ENTRY_TRAIN_ROUTES)
    logs_equal = [a["logs"] == b["logs"] for a, b in zip(first[2:], resumed)]
    res = root / "resumed" / EXP
    # 4.state's epoch is 1 in (a) and 0 in (b), which reruns epoch 0 (C3)
    files_equal = {name: _flax_file_equal(run / name, res / name, keys)
                   for name, keys in (("models/4_G.ckpt", None),
                                      ("training_state/4.state",
                                       ("iter", "opt_state", "params")))}
    for name in ("models/2_G.ckpt", "training_state/2.state"):
        if (run / name).read_bytes()[:4] == b"PK\x03\x04":
            raise AssertionError(f"[15a] {name} is a torch file")
    rtext = "".join(p.read_text() for p in res.glob("train_*.log"))
    log(f"[15b] resumed from the JAX-format 2.state: steps 3-4 logs equal "
        f"{logs_equal}, 4_G.ckpt and 4.state's iter, opt_state and params "
        f"bit-equal {files_equal} (cuDNN deterministic)")
    if (not all(logs_equal) or not all(files_equal.values())
            or "Start training from epoch: 0, iter: 2" not in rtext):
        raise AssertionError(f"[15b] the resumed run is not the whole run: "
                             f"{logs_equal}, {files_equal}")
    evals, mem = taps.calls["15c eval"], taps.calls["15c in memory"]
    sr_equal = [torch.equal(a["sr"], b["sr"]) for a, b in zip(evals, mem)]
    want = {k: v for k, v in {"packed_g123": 2, "style_blend_dot": 2,
                              "head_dot": 1, "output_stage_x8": 1}.items()}
    check_launches("15c eval", evals, want, {})
    log(f"[15c] test.main from 4_G.ckpt ({len(evals)} images, LR 128², "
        f"unbucketed): SR bit-equal to the in-memory weights' {sr_equal}; "
        f"launches an image {evals[0]['launches']}, routes "
        f"{ {k: evals[0]['routes'][k] for k in FLAGSHIP4} }")
    if len(evals) != 2 or not all(sr_equal):
        raise AssertionError(f"[15c] SR from 4_G.ckpt not the in-memory "
                             f"model's: {sr_equal}")
    launches = {label: {c.__name__: sum(r["launches"][c.__name__]
                                        for r in taps.calls[label])
                        for c in counters}
                for label in ("15a train", "15b resumed", "15c eval")}
    t = time.perf_counter()
    launches["15d fixture"], numbers = p15_fixture(torch, counters)
    secs["15d"] = time.perf_counter() - t
    shutil.rmtree(root, ignore_errors=True)
    numbers.update(seconds=time.perf_counter() - t0, parts_s=secs,
                   train_ms_per_step=sum(r["secs"] for r in first[1:]) / 3
                   * 1e3)
    log(f"[phase 15] took {numbers['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
        + f"); ×8 fp32 step {numbers['train_ms_per_step']:.1f} ms (mean of "
        f"steps 2-4, host clock, synchronised, cuDNN deterministic); "
        f"{gpu_line()}")
    return launches, numbers


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--p14-rank"]:          # a rank phase 14 spawned
        return _p14_rank(torch, sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--gloo-probe"]:        # which collectives gloo carries
        print(json.dumps(gloo_probe()))
        print(gpu_line())
        return 0
    from endosr_torch.kernels import _build

    if sys.argv[1:2] == ["--p14-nccl"]:          # a call on several cards
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        log(f"device: {gpu_line()} × {torch.cuda.device_count()}; built "
            f"{_build.build_all()}")
        print(json.dumps(p14_multi(torch, int(sys.argv[2])), default=str))
        print(gpu_line())
        return 0
    from endosr_torch.kernels.fused_in_mod import fused_in_mod
    from endosr_torch.kernels.fused_mod import fused_modulation
    from endosr_torch.kernels.fused_obranch import fused_o_branch
    from endosr_torch.kernels.fused_tail import fused_tail
    from endosr_torch.kernels.head_dot import head_dot
    from endosr_torch.kernels.in_stats import in_stats
    from endosr_torch.kernels.output_stage import output_stage, output_stage_x8
    from endosr_torch.kernels.packed_chain import packed_g123
    from endosr_torch.kernels.shuffle_mid import mid_shuffle
    from endosr_torch.kernels.style_dot import style_blend_dot, style_dot_hwbm

    t_start = time.perf_counter()
    gpu = gpu_line()
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} | nvidia-smi: {gpu} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    times = _build.build_all()
    log(f"built kernels (seconds since the builds started): "
        + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))
    for src in _build.SOURCES:
        txt = (_build.BUILD / f"{src}.log")
        if txt.exists():
            for line in txt.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {src}: {line.strip()}")

    for src, kern in (("head_dot", "conv_wgmma_kernel"),
                      ("fused_tail", "conv_wgmma_kernel"),
                      ("packed_chain", "conv_wgmma_kernel"),
                      ("fused_mod", "fused_mod_wgmma_kernel"),
                      ("style_dot", "style_dot_tc_kernel"),
                      ("style_dot", "style_blend_tc_kernel"),
                      ("in_stats", "in_stats_vec16_kernel"),
                      ("fused_in_mod", "in_mod_apply_vec16"),
                      ("output_stage", "output_stage_x8_vec16_kernel"),
                      ("output_stage", "output_stage_vec16_kernel")):
        log(f"  {kern} ({src}): " + ptxas_usage((_build.BUILD / f"{src}.log").read_text(),
                                        kern))

    rows = check_kernels(torch)
    small_forwards(torch)
    counters = [packed_g123, style_blend_dot, head_dot, output_stage_x8,
                output_stage, style_dot_hwbm, fused_in_mod, in_stats,
                fused_o_branch, fused_modulation, fused_tail, mid_shuffle]
    by_path = serving_paths(torch, counters)
    by_path["train x8"], train_ms, train_peak, bf16 = train_flagship(
        torch, counters)
    parity = train_parity(torch)
    grads = kernel_gradients(torch, counters)
    log(f"[train] summary: {json.dumps({'ms_per_step': train_ms, 'peak_gib': train_peak, 'bf16': bf16, **parity})}")
    entry, numbers = entry_points(torch, counters)
    by_path.update(entry)
    log(f"[entry] summary: {json.dumps(numbers)}")
    x23, numbers = serving_x2_x3(torch, counters)
    by_path.update(x23)
    for kname, errs in numbers["kernel_max_abs_err"].items():
        for dts, err in errs.items():
            have = rows[kname]["max_abs_err"]
            have[dts] = max(have[dts], err)
    log(f"[x2/x3] summary: {json.dumps(numbers)}")
    p9, numbers = phase9(torch, counters)
    by_path.update(p9)
    for kname, errs in numbers["kernel_max_abs_err"].items():
        for dts, err in errs.items():
            have = rows[kname]["max_abs_err"]
            have[dts] = max(have[dts], err)
    log(f"[phase 9] summary: {json.dumps(numbers)}")
    p10, numbers = phase10(torch, counters)
    by_path.update(p10)
    for kname, errs in numbers["kernel_max_abs_err"].items():
        for dts, err in errs.items():
            have = rows[kname]["max_abs_err"]
            have[dts] = max(have[dts], err)
    log(f"[phase 10] summary: {json.dumps(numbers)}")
    p11, numbers = phase11(torch, counters)
    by_path.update(p11)
    log(f"[phase 11] summary: {json.dumps(numbers)}")
    p12, numbers = phase12(torch, counters)
    by_path.update(p12)
    for kname, errs in numbers["kernel_max_abs_err"].items():
        for dts, err in errs.items():
            have = rows[kname]["max_abs_err"]
            have[dts] = max(have[dts], err)
    log(f"[phase 12] summary: {json.dumps(numbers)}")
    p13, numbers = phase13(torch, counters)
    by_path.update(p13)
    log(f"[phase 13] summary: {json.dumps(numbers)}")
    p14, numbers = phase14(torch, counters)
    by_path.update(p14)
    for kname, errs in numbers["kernel_max_abs_err"].items():
        for dts, err in errs.items():
            have = rows[kname]["max_abs_err"]
            have[dts] = max(have[dts], err)
    log(f"[phase 14] summary: {json.dumps(numbers, default=str)}")
    p15, numbers = phase15(torch, counters)
    by_path.update(p15)
    log(f"[phase 15] summary: {json.dumps(numbers)}")

    out = []
    for kname, (src, repl) in SOURCES.items():
        r = rows[kname]
        if kname in grads:
            grad = {"grad_checked": True, "grad": "*_vjp",
                    "grad_max_rel_err": grads[kname]}
        elif kname == "mid_shuffle":     # phase 3: bit-identical
            grad = {"grad_checked": True, "grad": "un-shuffle kernel",
                    "grad_max_rel_err": {"float32": 0.0, "bfloat16": 0.0}}
        elif "[" in kname:               # an option: its VJP held on the CPU
            grad = {"grad_checked": False, "grad": "*_vjp (held to JAX's on "
                    "the CPU)", "grad_max_rel_err": None}
        else:
            grad = {"grad_checked": True, "grad": "none: raises under "
                    "autograd on CUDA", "grad_max_rel_err": None}
        out.append({
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": sum(p.get(kname, 0) for p in by_path.values()),
            "launches_by_path": {k: p.get(kname, 0)
                                 for k, p in by_path.items()},
            "max_abs_err": r["max_abs_err"]["bfloat16"],
            "max_abs_err_fp32": r["max_abs_err"]["float32"],
            "ms": r["ms"], "call_ms": r["call_ms"], "timing": r["timing"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **({"previous_ms": r["previous_ms"]} if "previous_ms" in r else {}),
            **grad})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": out}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
