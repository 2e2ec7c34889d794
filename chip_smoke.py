#!/usr/bin/env python3
"""Smoke test of basedet_tpu_torch on one NVIDIA GPU:

    python3 chip_smoke.py [--profile DIR] [--parent-iou IOU_CU]

Run from the root of the repository. Phases, each of which raises on failure:
  1. device: require CUDA, print the card's name and power limit. The script
     sets no precision: the port's models and train step run in IEEE f32
     (TF32 off) by themselves, or under the bf16 policy where a phase's
     config asks for it, and phases 7, 8, 9c, 12, 12b, 17, 22, 29, 37 and 41
     hold them to the CPU;
  2. build the kernels afresh, in parallel: basedet_tpu_torch/csrc/nms.cu,
     csrc/matching.cu, csrc/roi_align.cu (RoIAlign's forward and backward
     in one library), csrc/fused_bn.cu (the fused 1x1-GEMM + BN-statistics
     forward and backward), csrc/scatter_rows.cu (the DCN row scatter) and
     csrc/iou.cu (pairwise IoU), with their ptxas reports;
  3. hold the NMS kernel to its plain PyTorch version on the card, exactly,
     on random batches at the YOLOX eval shape, at Faster R-CNN's three
     shapes (the RPN's at eval, K = 4819, and at training, B = 2 and
     K = 8819, and the final class-aware NMS, K = 2000), at RetinaNet's
     final NMS (K = 5000) and on edge cases (among them the word-blocked
     sweep's: K = 63, 64, 65 and 4097, invalid boxes on word edges,
     interleaved and filling a word, nothing suppressed, a chain of
     suppressions); time both, with the
     mask and sweep launches apart (profiler);
  4. the same for the SimOTA matching kernel, at the train slice's shape
     (8, 100, 8400) and on edge cases and one 832x832 case; time it at 3 and
     40 valid gts per image and at 832x832 (40 valid), events beside its
     device time (profiler), and check that a call is one device operation;
  4b. hold the RoIAlign kernel to its plain version within 1e-5 of
     max(1, max|F|), at Faster R-CNN's eval shape (B = 1 and 2, R = 1000,
     C = 256, the levels of an 800x1344 input), on edge cases (C = 256, 100
     and 6) and on channels-last features; time both, and split the call's
     device time (profiler) into the kernel's and anything else's, which
     must be nothing (the kernel reads the FPN's NCHW levels in place);
  4c. hold the RoIAlign backward kernel to its plain version within 2e-5 of
     max(1, max|dF|) (ROI_BWD_RTOL says why not 1e-5), at Faster R-CNN's train
     shape (B = 2, R = 512, C = 256) on proposal-like RoIs, on edge cases (and
     |g|~1e3) and on 512 identical RoIs (the most RoIs on one tile); check that
     two runs are bit-equal and every dF is NCHW-contiguous; time both, the
     kernel's device time (profiler) apart from anything else, which must be
     nothing (one device operation a call);
  4d. the bf16 RoIAlign kernels (the JAX package's Pallas kernels' own dtype)
     against their plain bf16 versions on 4b's and 4c's cases (proposal-like
     at B = 1 and at the train shape B = 2, R = 512, edges, |F| and |g| ~ 1e3,
     C = 100 and 6, channels-last, identical RoIs) and on their own
     (``bf16_edge_rois``: windows past the forward's staging room, windows
     from odd columns of P4 and P5, whose rows are not 16-byte aligned, B = 2
     with another level mix per image): elementwise within one bf16 ulp, or,
     for values so near 0 that the f32 sums' order alone moves them further,
     within the f32 kernels' own gates (``_bf16_gate``); the backward's two
     runs bit-equal, dF bf16 and NCHW-contiguous; each timed by device time
     beside the f32 kernel on the same RoIs, with the ratio of the two and
     each one's fraction of its bound;
  5. drive training through its entry point: det_train on full-width YOLOX-S
     (random weights from a seed, spread as for eval), batch 8 of 640x640
     with the multiscale resize live (832x832 on these steps), 4 steps; check
     the matching kernel and the IoU kernel (SimOTA's) ran once per step and
     their plain versions never, the losses are finite and the checkpoints
     written; then hold the matching kernel to its plain version on the cost
     and ious of the run's first step; keep that step's IoU arguments;
  6. drive the eval slice through its entry point: det_test on det_train's
     dumped weights over 8 requests of one 640x640 image, checking the NMS
     kernel ran, the plain version did not, and NMS suppressed; here and on
     every det_test below the IoU kernel and its plain version run 0 times;
  7. hold the card's inference to a CPU run of the same weights and image;
  8. hold one train step on the card to one on the CPU, same weights and
     batch of 2 at 640x640: losses, foreground anchors, gradient norm, BN
     statistics;
  9. time YOLOX-S f32 inference at batch 1 and batch 32, and one f32 train
     step at batch 8 of 640x640 split into its parts, with peak memory; then
     the assignment and the step with their IoU through the kernel and
     through the plain version (before the routing), in turns, each with its
     peak memory;
  9a. hold the fused 1x1-GEMM + BN-statistics kernels, forward and backward,
     to their plain versions on the 36 fused calls of a bf16 YOLOX-S train
     forward at batch 8 of 640x640 (every distinct shape, real activations)
     and on edge cases (ragged M, 1-4 raw inputs, act + raw, K = N = 512,
     K and N not multiples of 64, ds = dss = 0, and a raw term of 7 and of 13
     inputs at YOLOX-M's and YOLOX-X's depths; the strip kernels' M = 1, 127
     and 129 and N = K = 8; YOLOX-M, -L and -X's dark5 conv3, N = 768-1280,
     and 16 raw inputs at N = 640, where the backward streams w), within
     FUSED_SUM_RTOL, and two runs of each kernel bit-equal on every case;
     time the backward where it streams w; time each shape, kernel (the forward
     called as training calls it: inputs needing gradients, gradients on),
     plain version and the yardsticks (torch.matmul + column sums for the
     forward, two torch.matmul a term for the backward), and sum them over a
     step; replay the step's 36 forward calls in order: events time,
     fwd_kernel's device time (profiler) and host time per call, then events
     and host time with gradients off; replay its 36 backward calls in one
     torch.autograd.grad pass, as a train step's backward runs them: events
     time, the device time of everything they run and operations per call
     (profiler), host time per call, and the yardstick's events and device
     time on the same calls in order;
  9b. det_train --amp TRAINER.AMP.FUSED_BN True on full-width YOLOX-S, 4
     steps of 8 images (832x832 after the multiscale resize): 36 forward and
     36 backward fused launches per step, the matching and IoU kernels once,
     plain versions never; then the kernels held to their plain versions, within
     FUSED_SUM_RTOL, on the first backward call of each distinct 832x832
     shape, with the inputs and cotangents the step gave it; then det_test
     on its dumped_model.pt, in f32;
  9c. one bf16 train step with the fused chain, batch of 2, on the card with
     the kernels, on the card with their plain versions in their place, and
     on the CPU (plain versions): the kernels held to their plain versions on
     each of the card step's 36 calls (FUSED_SUM_RTOL); foreground agreement,
     then on the CPU's assignment the card's losses, gradient and BN
     statistics against both other steps (AMP_*: the gradient may turn no
     further than bf16 turns it from an f32 step on the CPU);
  9d. time the bf16 train step at batch 8 of 640x640 with the fused chain off
     and on, beside the f32 step, with the fused kernels' share and peak
     memory;
 10. with --profile DIR only: a torch.profiler pass over YOLOX-S inference
     at both batch sizes and over the train step of phases 9 and 9d (f32,
     bf16 with the fused chain off and on), kernel tables written to DIR,
     busy time and idle share;
 11. Faster R-CNN R50-FPN (full width, random weights from a seed with the
     frozen BN statistics, affine and biases spread) through det_train:
     batch 2 of 800x1333, 4 steps; check that per step the RoIAlign forward
     kernel, its backward kernel and the NMS kernel each ran once, the IoU
     kernel twice (RPN targets, R-CNN sampling; their arguments kept) and the
     plain versions never, that the losses are finite and that the sampled
     RoIs landed on every level P2-P5; then det_test on its dumped weights
     over 8 requests of one 800x1333 image: the RoIAlign kernel 8 times, the
     NMS kernel 16, their plain versions never, proposals on every level;
 12. hold its card inference to a CPU run of the same weights and image:
     proposals and detections slot by slot;
 12b. hold one train step on the card to one on the CPU, same weights, batch
     and sampling noise (drawn once, copied): the RPN labels and losses
     directly, and the R-CNN stages, the total's gradient norm included, on
     the CPU run's proposals (a few proposal slots differ between the
     devices, after which the two would sample other RoIs);
 13. time its inference at batch 1 and batch 8, split into backbone+FPN,
     RPN+proposals, RoIAlign, box head and post-process, with peak memory;
     and one train step at batch 2, split by the module's stage methods,
     with the RoIAlign backward's own time, images/s and peak memory; the
     RoIAlign backward on the step's own g (events and device time), then one
     backward under the profiler: the copies and adds on a dF-sized tensor
     after it and the NHWC kernels (convolution gradients, layout
     conversions) the backward runs; the RPN targets, the R-CNN sampling and
     the step with their IoUs through the kernel and through the plain
     version, as in phase 9;
 14. CenterNet R50-DCNv2 (full width, random weights from a seed with BN,
     biases and the DCN offset branches spread) through det_train: batch 16
     of 512x512, 4 steps; check that the scatter kernel ran three times per
     step (once per DCN stage, in the backward), its segmentation as often,
     and its plain version never, the losses are finite and the checkpoints
     written; keep the first step's three scatter calls;
 15. hold the scatter kernel to its plain version within SCATTER_RTOL of the
     sum of |values| per element on those three calls (the step's own row
     ids and cotangents, f32 and cast to bf16) and on edge cases (all
     entries on one row, rows of ~115 entries, empty rows, out-of-range
     indices, N and D off the tile, D = 12, B = 1, bf16 at D = 13 and 256),
     two kernel runs bit-equal each time; the segmentation kernels equal to
     row_segments (ids and starts), and on bf16 values the bf16 output
     bit-equal to the plain f32 sum cast; time each stage's call as the f32
     and the --amp step make it (f32 values to f32, bf16 to bf16), its
     kernels' device time apart (no sort kernel in a call), the bound, the
     plain version and index_add_ (bf16: of the values in f32, then cast);
 16. det_test on its dumped weights over 8 requests of one 512x512 image;
 17. card against CPU on a batch of 2 at full width: eval head outputs and
     detections, then one train forward and backward: losses, gradient
     norm, new BN running statistics;
 18. time its train step at batch 16, split into backbone, the three
     deconvolution stages, heads, targets + losses, backward (with the
     scatter calls' share) and SGD, with peak memory; with --profile, a
     profiler pass over that step;
 19. RetinaNet R50-FPN (full width, random weights from a seed with the
     frozen BN statistics and affine and the biases spread, the class biases
     by 2 around the prior) through det_train: batch 2 of 800x1333, 4 steps;
     check that the IoU kernel ran once per step (the anchor assignment, 100
     padded gts x 201,600 anchors per image) and its plain version never,
     the losses are finite, every step has foreground and ignored anchors
     and the run low-quality matches; keep the IoU calls' arguments;
 20. hold the IoU kernel to its plain version bit for bit (the sign of zero
     included), two runs bit-equal, on the first step's own arguments of
     each main path (RetinaNet's gts and anchors, Faster R-CNN's RPN targets
     and R-CNN sampling, YOLOX's SimOTA at 832x832), on 100 gts of COCO-like
     sizes per image against the RPN's anchors, on a case where every pair
     overlaps, the 2-D (300, 130) and on edge cases (zero-area, inverted,
     identical, touching and disjoint boxes, coordinates up to 1e4, M = 1, N
     off the block, -0.0 coordinates, every pair overlapping); time each of
     the first seven by device time (profiler) and events beside the plain
     version, the bound and the share of pairs computed in full; with
     --parent-iou, another tree's csrc/iou.cu is built and timed beside, in
     turns (parent, change, change, parent);
 21. det_test on its dumped weights over 8 requests of one 800x1333 image:
     the NMS kernel 8 times at K = 5000, its plain version never, NMS
     suppressing, detections on every request;
 22. card against CPU, f32: det_test's first request
     stage by stage (res3-res5, P3-P7, per-level logits and offsets) and its
     detections; one train forward and backward at batch 2: anchor labels,
     losses, gradient norm;
 23. time its train step at batch 2, split into backbone+FPN, head, the IoU
     kernel alone, the assignment, the losses, backward and SGD, with peak
     memory; after the other models' timing, its inference at batch 1 and
     8 (network, per-level top-1000 + decode, NMS + rescale); with
     --profile, a profiler pass over the train step;
 24. the data slice: the synthetic COCO set of tools/sanity_e2e.py, 96
     train and 16 val PNGs of 640x640 written by the port; os.cpu_count()
     and whether Pillow imports (only JPEG would need it);
 25. det_train on full-width YOLOX-S (3 classes, random init) over it:
     mosaic and mixup in min(8, cores) DataLoader workers, batches of 8 with
     the multiscale resize, 2 epochs of 10 steps with NO_AUG_EPOCH 1; the
     matching and IoU kernels once per step, the no-aug switch turning
     mosaic and mixup off and forking the workers anew, EvalHook on the 16
     val requests with the live and EMA weights (NMS once per request),
     plain versions never; the median data_time and step time;
 26. det_train --resume into the same directory with MAX_EPOCH 3: restored
     at step 20, trained epoch 3 only, evaluated again;
 27. 2 steps each of Faster R-CNN and CenterNet over the set through
     DataloaderBuilder and their AUG.TRAIN_VALUE, kernel counts per step as
     in phases 11 and 14;
 28. tools/bench_pipeline at 0 and 8 workers, the serial split of a
     batch (the pack's share) and one batch's copy to the card from pinned
     and from pageable memory; YOLOX-S f32 train steps fed by the real
     loader against DummyLoader, with the device's idle share;
 29. FCOS R50-FPN (full width, random weights from a seed: frozen BN and
     GroupNorm affine and every bias spread, class biases by 2, box biases
     raised so that boxes overlap): det_train, 2 steps of 2 images of
     800x1333, with MODEL.WEIGHTS a backbone-only R50 pickle in the
     reference's ImageNet layout (``utils/reference_layout.py``, values from
     a seed): loaded by matching, 265 trunk leaves matched, the FPN and head
     missing (left at their init), fc unused, the stem and frozen BN buffers
     equal to the file's after the run; no kernel on its train path;
     det_test on the spread weights over DummyLoader's 8 requests (the
     weights load by matching with nothing missing or unused; NMS once a
     request at K = 5000, suppressing; everything else 0); card against CPU, f32: the
     head outputs per level, the detections, then one train forward and
     backward at batch 2: point labels, losses, gradient norm;
 30. ATSS R50-FPN: det_train 2 steps (#10 once a step: the gts against the
     22,400 shared pseudo-anchors), #10 held bit for bit to its plain
     version on the first step's own arguments, two runs bit-equal, and
     timed; det_test over 8 requests as in 29;
 31. OTA R50-FPN (MATCHING "topk"): det_train 2 steps (#2 once a step over
     (2, 100, 22,400): rows past the staged 16,384, so streamed; costs with
     the 1e6 and 1e9 penalties), #2 held exactly to its plain version on the
     first step's own cost, ious and valid, two runs equal, and timed
     (events and profiler device time); det_test over 8 requests; one train
     step with MATCHING "sinkhorn" on the card (no kernel, finite losses);
 32. FreeAnchor R50-FPN: det_train 2 steps (#10 twice a step: the gts
     against each image's 201,600 predicted boxes, then against the shared
     anchors), both calls held bit for bit and timed; det_test over 8
     requests;
 33. each of the four: one f32 train step at batch 2 of 800x1333 split into
     backbone+FPN, head, assignment, losses, backward and SGD, with peak
     memory above what the script held before the model was built; the
     head's layers' device times and allocations, and the head with TF32
     allowed (FreeAnchor: its two stable sorts of (2, 100, 201,600) timed
     beside torch.topk);
 34. each of the four: inference at batch 1 of 800x1333, split into the
     network, the per-level top-1000 + decode and NMS, with the request's
     peak memory above what was held before it, plus the weights;
 35. YOLOv3 Darknet-53 (full width, train-mode BN; random weights from a
     seed with BN statistics and affine and every bias spread, the objectness
     and class biases by 2 around -2) through det_train: 2 steps of 8 images
     of 800x1333 (the config's batch); #10 twice a step (the gts' centred
     boxes against the 9 anchors, (8, 100) x (9,); every level's decoded
     boxes against each image's gts in one call, (8, 66,150) x (8, 100)),
     plain 0, the ignore mask neither empty nor full; #10 held bit for bit to
     its plain version on the first step's two calls, two runs bit-equal, and
     timed; DETR R50 (FrozenBN, freeze_at 2, 6 + 6 layers of width 256, 8
     heads, FFN 2048, dropout 0.1 from the step's generator, 100 queries;
     frozen BN and biases spread, class biases by 2) through det_train with
     DetrSolver's AdamW and its 0.1 gradient clip: 2 steps of 2 images of
     800x1333, no kernel and no plain version, the auction's rounds and host
     syncs per step;
 36. det_test on each one's dumped weights over 8 requests of one 800x1333
     image: YOLOv3's NMS once a request at K = 3000, suppressing, plain 0;
     DETR no kernel, 100 detections a request;
 37. card against CPU, f32: YOLOv3 at batch 2 (the three eval maps, the
     detections, one train pass's losses, gradient norm and new BN
     statistics); DETR at batch 2 with dropout 0 (every decoder layer's
     logits and boxes, the owners, losses and gradient norm);
 38. each one's f32 train step split into its stages (YOLOv3: backbone, FPN,
     targets + ignore mask, losses; DETR: backbone, encoder, decoder, heads,
     matching, losses), backward and the optimizer, with its own peak
     memory; then inference at batch 1 (network and post-process);
 39. det_train --amp on the nine other families at full width, 2 steps of
     each config's batch (RetinaNet, FCOS, ATSS, OTA, FreeAnchor, Faster
     R-CNN and DETR 2 of 800x1333, CenterNet 16 of 512², YOLOv3 8 of
     800x1333): finite losses, each kernel's launches per step as in f32 but
     Faster R-CNN's RoIAlign through the bf16 kernels (1 forward, 1
     backward a step, the f32 ones 0) and CenterNet's #9 on bf16 values,
     plain 0; det_test (f32) on each dump, 8 requests;
 40. each family's bf16 step beside its f32 step (events, means of 3), with
     peak memory and the device's idle share;
 41. card against CPU under the bf16 policy, one train pass of RetinaNet
     (batch 2), Faster R-CNN (batch 4, noise copied) and CenterNet (batch
     2, BN on running statistics) at 512x512, held with the CPU tests'
     yardstick (losses 10%, gradient norm 15%, cosine at least half the
     CPU's bf16-vs-f32 cosine, which must be 0.5 or more);
 42. TRAINER.REMAT on full-width YOLOv3 in f32: one pass each without
     REMAT, with True and with "selective" at batch 8 (losses and gradient
     norm equal within 1e-5, peak memory, launches counted per pass: #10's
     calls lie outside every segment), then batch 16 with True (peak, step
     time; it must fit the card);
 43. data-parallel det_train at world size 1 over NCCL: ``python -m
     torch.distributed.run --nproc-per-node 1`` runs this script as the
     worker (``--dp-worker``), which drives det_train --multi-host on
     full-width YOLOX-S, batch 8 of 640x640, 4 steps, f32; under the process
     group the cross-rank BN and the gradient all-reduce run at world size 1
     (their calls counted). Each step's losses against the plain det_train's
     on the same batches (DP_LOSS_RTOLS by step; the state after the steps
     reported), the step wall time beside the plain one, #2 and #10 once a
     step, plain 0;
 44. two ranks sharing the card over gloo (``--nproc-per-node 2
     --dist-backend gloo``): full-width YOLOX-S at 4 a rank against the plain
     det_train at 8, Faster R-CNN R50-FPN at 1 a rank against 2, 2 steps
     each: rank 0's parameters and BN buffers to rtol 1e-4, atol 1e-6 of the
     plain run's (YOLOX-S: the update of its parameters and of its BN
     buffers, each as a whole, to DP_UPDATE_RTOL: see there why), both
     ranks' state_dicts
     bit-equal, each step's losses by DP_LOSS_RTOLS, each kernel's launches
     per rank, which gloo collectives take CUDA tensors; each rank writes its
     results to a file under the phase's directory, which the phase reads;
 45. tensor parallelism: full-width DETR R50, 2 steps of 2 images of
     800x1333, through ``det_train --multi-host TRAINER.TP_SIZE 2`` on two
     ranks sharing the card over gloo (data 1 x model 2: every FFN split over
     them), against the plain det_train on the same weights and batches
     (losses by DP_LOSS_RTOLS, the state as a whole to TP_UPDATE_RTOL and
     reported tensor by tensor), the ranks bit-equal, the step time beside
     the plain step's;
 46. trace_net (torch.export) on full-width YOLOX-S at 640x640 and Faster
     R-CNN R50-FPN at 800x1344, each program reloaded and run beside the
     eager module (outputs within EXPORT_RTOL, discrete outputs and
     post_process's detections equal); Faster R-CNN's program holds NMS and
     RoIAlign as custom ops and launches their kernels as the eager module
     does (the profiler's counts by kernel name, the wrappers' counts);
 47. profile_net on YOLOX-S training, batch 8 of 640x640, 3 steps: the
     Chrome trace parses and holds #2 and #10 once a step;
 48. analyze_net on the ten families' configs: parameters and FLOPs;
 49. full-width YOLOX-M (depth 0.67, width 0.75; random weights from SEED)
     through a long run's machinery: its card forward against the CPU's
     (heads 1e-3); det_train over the synthetic set with --tb
     (GLOBAL.TENSORBOARD.LOG_IMAGES True), GLOBAL.CKPT_BACKEND orbax and an
     evaluation every epoch, 2 epochs of 10 steps of 8 (#2 and #10 once a
     step, NMS once per val request and TensorBoard image batch, plain 0),
     the event files read back by the port's reader (every CRC-32C, the
     tags, the PNGs decoded by Pillow at the canvas's size); the loop's
     block at an epoch end, async hook against pickle hook on the same
     state; a truncated 3.pt.tmp dropped into the checkpoint directory, then
     --resume to a third epoch, which must restore 2.pt exactly and go on;
     det_test of 3.pt, its 12 metrics equal through the native matcher and
     _match_python, both timed there and on 500 COCO-like images; the same
     det_train under --amp TRAINER.AMP.FUSED_BN True (#3/#4 as often
     forward as backward every step, w streamed on dark5's N = 768, the
     kernels held to their plain versions on the first call of each of the
     run's shapes); the f32 and bf16 fused steps timed with peak memory and
     idle share; det_train --debug with one NaN weight must raise naming
     the module;
 50. tools/benchmark.py on the card, its classes called directly so that any
     failure fails the run: for each of its eleven names (RetinaNet, FCOS,
     ATSS, FreeAnchor, FasterRCNN, YOLOX-S, YOLOX-M, YOLOv3, CenterNet, OTA,
     DETR) a train row in f32 and one under --amp (batch 8 of 640x640) and an
     eval row at batch 1, 2 warm-up and 6 timed steps or requests each:
     every number finite and positive, the peak printed, each kernel's
     launches on the row's path as BENCH_TRAIN and BENCH_EVAL say and its
     plain version never; the host syncs of one f32 step and one request
     named by source line (torch.cuda.set_sync_debug_mode); YOLOX-S's f32
     step_ms within 5% of CUDA events around the same loop. Then Darknet-53
     (train-mode BN) under full-width RetinaNet's FPN: det_train 2 steps of
     2 images of 800x1333 (#10 once a step), det_test on its dump over 8
     requests (#1 once a request), plain 0;
 51. the HF backbone zoo (layers/backbone/hf_adaptor.py) under full-width
     detectors: RetinaNet on hf_resnet50 (auto_convert_cfg_to_hf) and Faster
     R-CNN on hf_regnety_040 (res2-res5), train-mode BN: det_train 4 steps
     of 2 images of 800x1333 (#10 once a step, Faster R-CNN also #1, #5 and
     #6 once and #10 twice), step wall time and peak memory; det_test on its
     dump over 8 requests (#1 once a request, Faster R-CNN #1 twice and #5
     once), plain 0; the dump on the card against the CPU on one request
     (backbone, FPN and head or proposals, detections);
 52. the fused CSP chain under data-parallel training: YOLOX-S dark3's
     CSPLayer over two ranks sharing the card over gloo against one process
     (output, input gradient, parameter gradients, running statistics, each
     within twice the kernels-vs-plain-versions difference on the same
     inputs); det_train --amp TRAINER.AMP.FUSED_BN True --multi-host, 3
     steps of 4 a rank, against one process at 8 (#3/#4 36 times a step a
     rank, #2/#10 once, plain 0; ranks bit-equal; the first step's losses
     held), beside the same run without the chain; world size 1 over NCCL;
 53. print the kernel report (ten kernels in six sources, the bf16
     RoIAlign variants apart; every kernel's launches path by path, the new
     paths and each data-parallel rank included), the card, and the result
     line.
"""
import argparse
import concurrent.futures
import contextlib
import functools
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
CONFIG = "basedet_tpu_torch/playground/yolox_s/config.py"
FRCNN_CONFIG = "basedet_tpu_torch/playground/faster_rcnn_r50_1x/config.py"
FRCNN_IMAGE = (800, 1333)  # padded to 800x1344: P2 200x336 ... P6 13x21
FRCNN_RPN_K, FRCNN_RPN_T = 1000 * 4 + 13 * 21 * 3, 0.7  # 4 levels x top-1000 + all of P6
FRCNN_FINAL_K, FRCNN_FINAL_T = 2000, 0.5
FRCNN_TRAIN_B, FRCNN_TRAIN_R = 2, 512  # MODEL.BATCHSIZE, RCNN.NUM_ROIS
FRCNN_TRAIN_RPN_K = 2000 * 4 + 13 * 21 * 3  # 4 levels x TRAIN_PREV_NMS_TOPK + all of P6
FRCNN_ANCHORS = 3 * (200 * 336 + 100 * 168 + 50 * 84 + 25 * 42 + 13 * 21)  # 268,569 at 800x1344
FRCNN_CANDIDATES = 1000 + 100  # TRAIN_POST_NMS_TOPK proposals + MAX_INSTANCES gt rows
RPN_LABEL_AGREE = 0.999
# RoIAlign backward against its plain version, as a share of max(1, max|dF|). 1e-5 holds where a
# pixel sums a few hundred terms; the proposal-like case's 102 zero-area padding RoIs all land on
# P2's corner pixel, which sums ~5,000 terms to |dF| ~ 195: there a kernel that summed with atomics
# measured 5.4e-6 off the plain version and 2.3e-6 off its own second run, too close to 1e-5 to
# hold on every run (NVIDIA H100 80GB HBM3, 700.00 W). The one-writer kernel sums each element in
# one fixed order (RoIs by index, then the bins), so its runs are bit-equal, but that order is
# still not the plain version's
ROI_BWD_RTOL = 2e-5
ROI_R, ROI_C, ROI_STRIDES = 1000, 256, (4, 8, 16, 32)
ROI_LEVELS = [(200, 336), (100, 168), (50, 84), (25, 42)]
FRCNN_ATOL, FRCNN_AGREE = 1e-3, 0.95
MODEL_REPS = 5  # timed runs of a whole model, stage or step (events, mean)
# NVIDIA H100 SXM data sheet: HBM3 rate, f32 rate outside the tensor cores, dense bf16 tensor cores
PEAK_BYTES_PER_S, PEAK_F32_PER_S, PEAK_BF16_PER_S = 3.35e12, 67e12, 989e12
SLICE_B, SLICE_K, SLICE_T = 8, 3000, 0.65  # YOLOX-S eval: 3 levels x top-1000, IoU 0.65
HEAD_ATOL = 1e-3
MATCH_B, MATCH_K, MATCH_M = 8, 100, 8400  # YOLOX-S train: batch 8, MAX_INSTANCES 100, 640x640
MATCH_M_832 = 104 * 104 + 52 * 52 + 26 * 26  # anchors at 832x832
LOSS_RTOL, FG_AGREE, GRAD_NORM_RTOL, STATS_RTOL = 1e-3, 0.999, 1e-3, 1e-4
RETINA_CONFIG = "basedet_tpu_torch/playground/retinanet_r50_1x/config.py"
RETINA_B = 2  # MODEL.BATCHSIZE
RETINA_LEVELS = [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]  # P3-P7 at 800x1344
RETINA_ANCHORS = 9 * sum(h * w for h, w in RETINA_LEVELS)  # 201,600
RETINA_FINAL_K, RETINA_FINAL_T = 5 * 1000, 0.5  # top-1000 per level, TEST.IOU_THRESHOLD
LABEL_AGREE = 0.999
CNET_CONFIG = "basedet_tpu_torch/playground/centernet_r50/config.py"
CNET_B, CNET_IMAGE, CNET_PARITY_B = 16, (512, 512), 2  # the config's batch; maps of 128x128
# Kernel #9 against its plain version: both add each row's entries in f32 in the original n order (bf16
# values convert exactly), so they should agree bit for bit; each output element is held to 4 f32 ulps of
# the sum of the |values| that land on it
SCATTER_RTOL = 4 * 2.0 ** -23
# The fused kernels against their plain versions: every output is an f32 sum taken in another
# order (tensor-core tiles and partial rows against cuBLAS and PyTorch's reductions), so each is
# held to FUSED_SUM_RTOL of the sum of the magnitudes of its terms, propagated through the
# prologue and epilogue, plus one ulp of its own dtype where it is rounded to bf16
FUSED_SUM_RTOL = 2.0 ** -17
# One bf16 train step with the fused chain (batch 2 of 640x640), card against CPU and kernels against their
# plain versions on the card. Train-mode YOLOX-S with random weights amplifies a perturbation ~300 times into
# the gradient (f32 card vs CPU: 2e-5 of the norm from ~6e-8 rounding), and bf16 rounds every element: the
# CPU's bf16 gradient lies 1.11 of its norm from its f32 one on one assignment, cosine 0.43. Any difference of
# rounding therefore spreads to that size: the kernels' step lies 0.685 of the norm from its plain-version
# step though every one of its calls lies within FUSED_SUM_RTOL of its plain version, cuDNN's against
# oneDNN's 0.70 (NVIDIA H100 80GB HBM3, 700.00 W). So the gradient is held to turn less than bf16 itself
# turns it (its cosine at least the CPU's bf16-vs-f32 cosine; measured 0.75 and 0.73), the losses to
# AMP_LOSS_RTOL (measured 5.9e-3 and 6.1e-3) and the new BN running statistics to AMP_STATS_RTOL (6.1e-4 and
# 5.2e-4 of max(|value|, 1)); foreground agreement on each device's own assignment (SimOTA's near-ties)
AMP_LOSS_RTOL, AMP_FG_AGREE, AMP_STATS_RTOL = 3e-2, 0.995, 1e-2


_START = time.perf_counter()


def log(msg=""):
    """Print ``msg``; a phase's line (one starting with its ``[tag]``) ends with the seconds since the
    script started, so that a run shows where its time limit goes."""
    print(f"{msg} [t+{time.perf_counter() - _START:.0f} s]" if msg.startswith("[") else msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class ProfilerMiss(RuntimeError):
    """torch.profiler reported none of the device operations asked for, pass after pass."""


# idle seconds inside a profiler window before and after the work: the profiler drops device records
# whose timestamps, converted to the host's clock, fall outside its window, and on the card's machine
# they land up to tens of ms off (scripts/profiler_window_probe.py counts what an unpadded pass misses)
PROFILER_PAD_S = 0.05


@contextlib.contextmanager
def padded_profile(activities, pad=PROFILER_PAD_S, **kwargs):
    """torch.profiler over the block, the block's device work synchronised and
    ``pad`` seconds of idle before and after it inside the window."""
    from torch.profiler import profile

    torch.cuda.synchronize()
    with profile(activities=activities, **kwargs) as prof:
        time.sleep(pad)
        yield prof
        torch.cuda.synchronize()
        time.sleep(pad)


def profiled(fn, iters, read, what="any device operation", attempts=6):
    """read(prof) of the first profiler pass over ``iters`` calls of fn (CUDA
    activity, a window padded on both sides by ``padded_profile``) for which
    read does not return None. A pass it rejects is repeated with twice the
    padding, up to ``attempts`` times, each retry noted on stderr."""
    from torch.profiler import ProfilerActivity

    for attempt in range(attempts):
        if attempt:
            print(f"chip_smoke: profiler pass {attempt} of {attempts} missed {what}; retrying", file=sys.stderr,
                  flush=True)
        with padded_profile([ProfilerActivity.CUDA], PROFILER_PAD_S * 2 ** attempt) as prof:
            for _ in range(iters):
                fn()
        result = read(prof)
        if result is not None:
            return result
    raise ProfilerMiss(f"chip_smoke: the profiler missed {what} in {attempts} passes")


def device_kernels(fn, iters, warmup=2, names=()):
    """Every device operation fn runs, from torch.profiler (``profiled``):
    (device ms per call of fn, operations (kernels, memsets, copies) per call,
    {name: device ms per call}); a pass must show some operation, and one
    whose name contains each of ``names``. A pass can also miss a launch or
    two (9 of 10 seen): each operation counts as its mean time a launch times
    its launches a call rounded to a whole number."""

    def read(prof):
        averages = prof.key_averages()
        key = "self_device_time_total" if len(averages) and hasattr(averages[0], "self_device_time_total") \
            else "self_cuda_time_total"
        ops = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA and getattr(e, key) > 0]
        per_call = {e.key: max(1, round(e.count / iters)) for e in ops}
        found = {e.key: getattr(e, key) / 1000 / e.count * per_call[e.key] for e in ops}
        if ops and all(any(n in k for k in found) for n in names):
            return sum(found.values()), sum(per_call.values()), found
        return None

    for _ in range(warmup):
        fn()
    return profiled(fn, iters, read, names or "any device operation")


def device_busy_span(fn, iters):
    """Per call of fn: (the sum of its device operations' durations, the time at least one of
    them runs, the span of the window's device work: first operation's start to the last one's
    end), all on the profiler's clock (``profiled``), so their ratios do not move with how that
    clock's rate differs from the CUDA events' (its stamps are converted to the host's clock; see
    PROFILER_PAD_S). The sum can exceed the span: device operations overlap (in YOLOv3's f32 step
    on an NVIDIA H100 80GB HBM3 at 700 W the sum came to 374.237 ms against a 372.074 ms span)."""

    def read(prof):
        ops = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        if not ops:
            return None
        busy = sum(end - start for start, end in ops)
        union, (run_start, run_end) = 0, ops[0]
        for start, end in ops[1:]:
            if start > run_end:
                union += run_end - run_start
                run_start = start
            run_end = max(run_end, end)
        union += run_end - run_start
        span = run_end - ops[0][0]
        return busy / 1000 / iters, union / 1000 / iters, span / 1000 / iters

    return profiled(fn, iters, read)


def device_ms(fn, iters, names, warmup=2):
    """Device time per call of fn, by kernel, from torch.profiler: {name: ms}
    summed over the kernels whose name contains name, for each of names."""
    found = device_kernels(fn, iters, warmup, names=names)[2]
    return {n: sum(v for k, v in found.items() if n in k) for n in names}


def host_us(fn, calls, passes=20):
    """Host time of fn per call it makes (``calls`` calls a pass): median of
    ``passes`` passes, each started on an idle card, as a printable range."""
    host = []
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
    host.sort()
    return host[len(host) // 2], f"{host[len(host) // 2]:.1f} us per call (median of {passes} passes, " \
                                 f"{host[0]:.1f}-{host[-1]:.1f})"


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this smoke test needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | process TF32 settings left as "
        f"they are (cudnn {torch.backends.cudnn.allow_tf32}, matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}); the model runs f32 itself")
    return card


def bound(bytes_moved, ops, peak_ops=PEAK_F32_PER_S):
    """The least time (ms) the card could take: bytes over the memory rate
    or operations over their peak rate (f32 unless given), whichever is
    larger, and which."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build():
    from basedet_tpu_torch.ops import (_build, fused_bn_kernel, iou_kernel, matching_kernel, nms_kernel,
                                       roi_align_kernel, scatter_rows_kernel)

    sources = [nms_kernel.SOURCE, matching_kernel.SOURCE, roi_align_kernel.SOURCE, fused_bn_kernel.SOURCE,
               scatter_rows_kernel.SOURCE, iou_kernel.SOURCE]
    for source in sources:
        _build.library_path(source).unlink(missing_ok=True)  # show the build from this checkout

    def build(source):
        t0 = time.perf_counter()
        path, report = _build.build_library(source)
        return source, path, report, time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(build, sources))
    log(f"[build] {len(sources)} kernels in {time.perf_counter() - t0:.2f} s, one nvcc each in "
        f"parallel (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for source, path, report, seconds in built:
        log(f"[build] {source.relative_to(source.parents[2])} -> {path.name} in {seconds:.2f} s")
        for line in report.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"[build]   {line.strip()}")


def _random_boxes(rng, B, K, clustered):
    """(B, K, 4) xyxy boxes on a 640x640 canvas; clustered ones jitter around
    a few dozen objects, so many pairs sit near the IoU threshold."""
    if clustered:
        centers = rng.uniform(0, 640, (B, 40, 2))
        sizes = rng.uniform(10, 200, (B, 40, 2))
        pick = rng.randint(0, 40, (B, K))
        c = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(0, 4, (B, K, 2))
        s = np.take_along_axis(sizes, pick[..., None], 1) * rng.uniform(0.85, 1.15, (B, K, 2))
        xy1, xy2 = c - s / 2, c + s / 2
    else:
        xy1 = rng.uniform(0, 640, (B, K, 2))
        xy2 = xy1 + rng.uniform(1, 640 / 3, (B, K, 2))
    return np.concatenate([xy1, xy2], -1).astype(np.float32)


def _kernel_cases():
    rng = np.random.RandomState(SEED)
    cases = []
    for seed in range(4):
        boxes = _random_boxes(rng, SLICE_B, SLICE_K, clustered=seed % 2 == 1)
        cases.append((f"slice seed{seed}", boxes, rng.uniform(size=(SLICE_B, SLICE_K)) > 0.1, SLICE_T))
    cases.append(("K=1037", _random_boxes(rng, 3, 1037, True), rng.uniform(size=(3, 1037)) > 0.3, 0.5))
    for name, K, t in (("frcnn rpn", FRCNN_RPN_K, FRCNN_RPN_T), ("frcnn final", FRCNN_FINAL_K, FRCNN_FINAL_T),
                       ("frcnn rpn train", FRCNN_TRAIN_RPN_K, FRCNN_RPN_T),
                       ("retinanet final", RETINA_FINAL_K, RETINA_FINAL_T)):
        cases.append((name, _random_boxes(rng, 2, K, True), rng.uniform(size=(2, K)) > 0.05, t))
    cases.append(("K=1", _random_boxes(rng, 2, 1, False), np.ones((2, 1), bool), SLICE_T))
    cases.append(("all invalid", _random_boxes(rng, 2, 500, True), np.zeros((2, 500), bool), SLICE_T))
    same = np.broadcast_to(np.float32([10, 20, 110, 220]), (2, 300, 4)).copy()
    cases.append(("identical boxes", same, np.arange(300)[None].repeat(2, 0) % 7 != 0, SLICE_T))
    # equal scores: a stable sort keeps index order among the ties
    boxes = _random_boxes(rng, 2, 2000, True)
    scores = np.round(rng.uniform(size=(2, 2000)), 1)
    order = np.argsort(-scores, axis=1, kind="stable")
    cases.append(("equal scores", np.take_along_axis(boxes, order[..., None], 1), np.ones((2, 2000), bool), SLICE_T))
    edge = np.float32([[0, 0, 10, 10], [0, 0, 10, 5], [20, 0, 30, 10], [20, 0, 30, 7.5]])
    tiled = np.concatenate([edge + 40 * i for i in range(32)])[None]  # inter == t*union exactly
    for t in (0.5, 0.75):
        cases.append((f"inter == {t}*union", tiled, np.ones(tiled.shape[:2], bool), t))
    # the word-blocked sweep's edges: K around one 64-box word and past 64 words, invalid boxes on
    # word boundaries, interleaved and filling a word, nothing suppressed
    rng = np.random.RandomState(SEED + 8)
    for K in (63, 64, 65, 4097):
        cases.append((f"K={K}", _random_boxes(rng, 2, K, True), rng.uniform(size=(2, K)) > 0.1, 0.5))
    boxes = _random_boxes(rng, 2, 320, True)
    at_edges = np.ones((2, 320), bool)
    at_edges[:, [0, 63, 64, 127, 128, 191, 255, 256, 319]] = False
    cases.append(("invalid at word edges", boxes, at_edges, 0.5))
    cases.append(("invalid interleaved", boxes, np.arange(320)[None].repeat(2, 0) % 2 == 1, 0.5))
    cases.append(("one word all invalid", boxes, np.arange(320)[None].repeat(2, 0) // 64 != 2, 0.5))
    grid = np.stack(np.meshgrid(np.arange(20) * 30.0, np.arange(15) * 30.0), -1).reshape(-1, 2)
    disjoint = np.concatenate([grid, grid + 20], 1).astype(np.float32)[None].repeat(2, 0)
    cases.append(("all disjoint", disjoint, np.ones(disjoint.shape[:2], bool), 0.3))
    # box k suppresses k + 1 and not k + 2: the sweep's Jacobi rounds do not settle on these words
    x = 3.0 * np.arange(150, dtype=np.float32)
    chain = np.stack([x, np.zeros_like(x), x + 10, np.full_like(x, 10)], 1)[None].repeat(2, 0)
    cases.append(("suppression chain", chain, np.ones(chain.shape[:2], bool), 0.5))
    return cases


def nms_bound(valid, keep):
    """NMS's bound on valid (B, K) and this run's keep (B, K): boxes and
    valid read once, keep written once; ~15 f32 operations per IoU test, and
    the fewest tests greedy NMS needs on this data: each kept box against
    every kept box before it, each suppressed valid box against one (its
    suppressor)."""
    B, K = valid.shape
    kept = keep.sum(1).double()
    suppressed = valid.sum(1).double() - kept
    return bound(B * K * (16 + 1 + 1), 15 * float((kept * (kept - 1) / 2 + suppressed).sum()))


def _nms_split(boxes, valid, t):
    """The NMS call's two launches apart: device time per call of the mask
    kernel and of the sweep, from the profiler."""
    from basedet_tpu_torch.ops.nms_kernel import nms_keep

    try:
        dev = device_ms(lambda: nms_keep(boxes, valid, t), 10, ("nms_mask_kernel", "nms_sweep_kernel"))
    except ProfilerMiss as e:  # the split is read, not held: the call's own time is measured with events
        return f"device split not measured ({e})"
    return (f"device: mask kernel {dev['nms_mask_kernel']:.4f} ms, sweep {dev['nms_sweep_kernel']:.4f} ms "
            f"(profiler)")


def phase_kernel(card):
    from basedet_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain

    worst = 0
    for name, boxes, valid, t in _kernel_cases():
        b = torch.from_numpy(np.ascontiguousarray(boxes)).cuda()
        v = torch.from_numpy(np.ascontiguousarray(valid)).cuda()
        got, ref = nms_keep(b, v, t), nms_keep_plain(b, v, t)
        torch.cuda.synchronize()
        diff = int((got != ref).sum())
        worst = max(worst, int((got.int() - ref.int()).abs().max()))
        log(f"[kernel] {name:18s} B={b.shape[0]} K={b.shape[1]} t={t}: "
            f"{int(ref.sum())} kept, {diff} differ")
        check(diff == 0, f"NMS kernel differs from nms_keep_plain on case {name!r}")
    n_cases = len(_kernel_cases())
    rng = np.random.RandomState(SEED + 1)
    b = torch.from_numpy(_random_boxes(rng, SLICE_B, SLICE_K, True)).cuda()
    v = torch.ones(SLICE_B, SLICE_K, dtype=torch.bool, device="cuda")
    ms = cuda_ms(lambda: nms_keep(b, v, SLICE_T), reps=50, warmup=5)
    plain_ms = cuda_ms(lambda: nms_keep_plain(b, v, SLICE_T), reps=3, warmup=1)
    keep = nms_keep(b, v, SLICE_T)
    kept = keep.sum(1).tolist()
    bound_ms, bound_by = nms_bound(v, keep)
    log(f"[kernel] {n_cases} cases equal; B={SLICE_B} K={SLICE_K} t={SLICE_T} (clustered, "
        f"kept per image {min(kept)}-{max(kept)} of {SLICE_K}): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms per call, bound {bound_ms:.6f} ms "
        f"({bound_by}); {_nms_split(b, v, SLICE_T)} | {card}")
    # the clustered shapes of the main paths, and YOLOX's eval shape on small scattered boxes, where
    # most boxes are kept (as random-weight YOLOX-S keeps ~2,800 of 3,000 in det_test)
    for name, B, K, t, clustered in (("frcnn rpn", 1, FRCNN_RPN_K, FRCNN_RPN_T, True),
                                     ("frcnn final", 1, FRCNN_FINAL_K, FRCNN_FINAL_T, True),
                                     ("frcnn rpn train", FRCNN_TRAIN_B, FRCNN_TRAIN_RPN_K, FRCNN_RPN_T, True),
                                     ("retinanet final", 1, RETINA_FINAL_K, RETINA_FINAL_T, True),
                                     ("yolox most kept", 1, SLICE_K, SLICE_T, False)):
        if clustered:
            b = torch.from_numpy(_random_boxes(rng, B, K, True)).cuda()
        else:
            xy = rng.uniform(0, 640, (B, K, 2))
            b = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(1, 12, (B, K, 2))], -1).astype(np.float32)).cuda()
        v = torch.ones(B, K, dtype=torch.bool, device="cuda")
        k_ms = cuda_ms(lambda: nms_keep(b, v, t), reps=50, warmup=5)
        p_ms = cuda_ms(lambda: nms_keep_plain(b, v, t), reps=2, warmup=1)
        keep = nms_keep(b, v, t)
        check(torch.equal(keep, nms_keep_plain(b, v, t)), f"NMS kernel differs from nms_keep_plain at {name}")
        k_bound, k_by = nms_bound(v, keep)
        log(f"[kernel] {name} B={B} K={K} t={t} ({'clustered' if clustered else 'scattered'}, {int(keep.sum())} "
            f"kept): kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms per call, bound {k_bound:.6f} ms ({k_by}); "
            f"{_nms_split(b, v, t)} | {card}")
    return dict(max_abs_err=float(worst), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def _matching_case(rng, B, K, M, valid):
    """YOLOX-like cost and ious: rows of valid gts get costs 0..30 plus 1e5
    off their centre region and ious peaked near 0, invalid rows cost 1e9
    and iou 0, as YOLOX._assign feeds the kernel."""
    cost = rng.uniform(0, 30, (B, K, M)) + 1e5 * (rng.uniform(size=(B, K, M)) > 0.02)
    ious = rng.uniform(size=(B, K, M)) ** 6
    cost = np.where(valid[..., None], cost, 1e9).astype(np.float32)
    ious = np.where(valid[..., None], ious, 0.0).astype(np.float32)
    return cost, ious, valid


def _matching_cases():
    rng = np.random.RandomState(SEED)
    prefix = lambda B, K, n: np.arange(K)[None].repeat(B, 0) < n
    cases = [(f"slice {n} valid", *_matching_case(rng, MATCH_B, MATCH_K, MATCH_M, prefix(MATCH_B, MATCH_K, n)))
             for n in (3, 40)]
    cost, ious, valid = _matching_case(rng, 2, MATCH_K, MATCH_M, prefix(2, MATCH_K, 40))
    cases.append(("tied costs", np.round(cost, 1), ious, valid))
    cost, ious, valid = _matching_case(rng, 2, 6, MATCH_M, np.ones((2, 6), bool))
    tops = [[0.9, 0.7, 0.6, 0.3, 0.2, 0.1, 0.1, 0.05, 0.03, 0.02], [0.7] * 10, [0.5] * 10,
            [0.1] * 10, [1.0, 1.0, 0.5, 0.5, 0.25, 0.25, 0.25, 0.25, 0.0, 0.0],
            [0.95, 0.9, 0.85, 0.8, 0.7, 0.6, 0.5, 0.4, 0.2, 0.1]]  # sums on or next to integers
    ious = (ious * 0.01).astype(np.float32)
    for g, top in enumerate(tops):
        ious[:, g, rng.permutation(MATCH_M)[:10]] = np.float32(top)
    cases.append(("integer sums", cost, ious, valid))
    cases.append(("invalid rows", *_matching_case(rng, 4, MATCH_K, 2000, rng.uniform(size=(4, MATCH_K)) < 0.3)))
    cases.append(("K=1", *_matching_case(rng, 2, 1, MATCH_M, np.ones((2, 1), bool))))
    cases.append(("M<10", *_matching_case(rng, 2, 5, 7, np.ones((2, 5), bool))))
    cases.append(("832x832", *_matching_case(rng, MATCH_B, MATCH_K, MATCH_M_832, prefix(MATCH_B, MATCH_K, 40))))
    return cases


def _check_matching(name, cost, ious, valid):
    from basedet_tpu_torch.ops.matching_kernel import dynamic_k_matching, dynamic_k_matching_plain

    best, fg = dynamic_k_matching(cost, ious, valid)
    torch.cuda.synchronize()
    ref_best, ref_fg = dynamic_k_matching_plain(cost, ious, valid)
    diff = int(((fg != ref_fg) | (best != ref_best)).sum())
    log(f"[match] {name:14s} B={cost.shape[0]} K={cost.shape[1]} M={cost.shape[2]}: "
        f"{int(ref_fg.sum())} foreground anchors, {diff} differ")
    check(diff == 0, f"matching kernel differs from dynamic_k_matching_plain on case {name!r}")
    return int((best - ref_best).abs().max()) + int((fg != ref_fg).sum())


def matching_bound(valid, M):
    """The matching's bound: cost and ious read once for valid rows, best gt
    (i32) and fg (bool) written per anchor; ~2 operations per element read."""
    rows = int(valid.sum())
    return bound(rows * M * 8 + valid.shape[0] * M * 5, 2 * rows * M)


def matching_timing(cases, card):
    """The matching kernel's wrapper on each (name, cost, ious, valid) case:
    events time per call, its device time and device operations per call
    (profiler), the plain version and the bound."""
    from basedet_tpu_torch.ops.matching_kernel import dynamic_k_matching, dynamic_k_matching_plain

    times = {}
    for name, *arrays in cases:
        cost, ious, valid = (torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays)
        call = lambda: dynamic_k_matching(cost, ious, valid)
        ms = cuda_ms(call, reps=50, warmup=5)
        device, ops, names = device_kernels(call, 20)
        plain_ms = cuda_ms(lambda: dynamic_k_matching_plain(cost, ious, valid), reps=MODEL_REPS, warmup=2)
        bound_ms, bound_by = matching_bound(arrays[2], cost.shape[2])
        times[name] = dict(ms=ms, device_ms=device, ops=ops, names=sorted(names), plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
        B, K, M = cost.shape
        log(f"[match] {name}, B={B} K={K} M={M}, {int(arrays[2].sum())} valid rows: kernel {ms:.4f} ms per call "
            f"(events), device time {device:.4f} ms in {ops:.2f} operations a call (profiler: {sorted(names)}); "
            f"plain {plain_ms:.3f} ms; bound {bound_ms:.5f} ms ({bound_by}) | {card}")
    return times


def phase_matching(card):
    cases = _matching_cases()
    worst = max(_check_matching(name, *(torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays))
                for name, *arrays in cases)
    log(f"[match] {len(cases)} cases equal")
    timed = [c for c in cases if c[0] in ("slice 3 valid", "slice 40 valid", "832x832")]
    times = matching_timing(timed, card)
    for name, t in times.items():
        check(t["ops"] == 1, f"the matching wrapper ran {t['ops']} device operations a call on {name!r}, not 1")
    t = times["slice 3 valid"]  # det_train's dummy batches carry 3 boxes per image
    return dict(max_abs_err=float(worst), ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=None)


@torch.no_grad()
def randomise(module, generator):
    """Draw BN statistics and affine and every conv bias from generator, as
    the CPU tests do, so scores spread out; then raise the box-size biases by
    log 4, so a box spans about four strides as a trained detector's box spans
    an object many anchors wide. Same-class neighbours then overlap and NMS
    suppresses on the main path; with the plain init it keeps everything."""
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0.0, 0.2, generator=generator)
            m.running_var.uniform_(0.5, 2.0, generator=generator)
            m.weight.uniform_(0.5, 1.5, generator=generator)
        if getattr(m, "bias", None) is not None:
            m.bias.add_(torch.empty_like(m.bias).normal_(0.0, 0.3, generator=generator))
    for name, m in module.head.named_children():
        if name.startswith("reg_pred_"):
            m.bias[2:].add_(math.log(4.0))


@contextlib.contextmanager
def recording(owner, name, keep=lambda args, out: args, substitute=None):
    """Replace ``owner.name`` with a wrapper that calls it and records
    ``keep(args, result)`` for each call, returning the result, or
    ``substitute(args)`` in its place where given; put it back on the way
    out."""
    fn, calls = getattr(owner, name), []

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(keep(args, out))
        return out if substitute is None else substitute(args)

    setattr(owner, name, wrapper)
    try:
        yield calls
    finally:
        setattr(owner, name, fn)


def nms_counts():
    """Record (valid candidates, kept) per image of every NMS call on the
    path, read from the wrapper's inputs and output on the way through."""
    from basedet_tpu_torch.ops import nms as nms_ops

    return recording(nms_ops, "nms_keep",
                     lambda args, keep: list(zip(args[1].sum(1).tolist(), keep.sum(1).tolist())))


IOU_COUNTS = {}  # main path -> (IoU kernel launches, plain IoU calls) in its run


@contextlib.contextmanager
def iou_counted(path):
    """Zero kernel #10's launch count and its plain version's call count just before the body (a
    main path's run) and keep both, read just after, under ``path``."""
    from basedet_tpu_torch.ops.iou_kernel import box_iou, box_iou_plain

    box_iou.launches, box_iou_plain.calls = 0, 0
    yield
    IOU_COUNTS[path] = (box_iou.launches, box_iou_plain.calls)


def check_iou_counts(path, expected):
    """The IoU kernel launched ``expected`` times on ``path`` and its plain version never."""
    launches, plain = IOU_COUNTS[path]
    check(launches == expected, f"{path}: the IoU kernel launched {launches} times, not {expected}")
    check(plain == 0, f"{path}: the plain IoU ran {plain} times on the main path")
    return f"IoU kernel launches {launches}, plain calls {plain}"


def _kept_range(calls):
    seen = [pair for call in calls for pair in call]
    kept = [k for _, k in seen]
    return f"{min(kept)}-{max(kept)} of {min(v for v, _ in seen)}-{max(v for v, _ in seen)} valid"


def make_weights(out_dir):
    """Full-width YOLOX-S on the card with random weights from SEED, spread
    by ``randomise``, saved as a state_dict. Returns (cfg for det_test,
    model, path)."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.tools import import_config

    cfg = import_config(CONFIG)
    cfg.merge(["DATA.TEST.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", "(640,640)",
               "GLOBAL.OUTPUT_DIR", out_dir])
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    model = build_model(cfg, "cuda", generator)
    randomise(model.module, generator)
    weights = os.path.join(out_dir, "yolox_s_seed0.pt")
    torch.save(model.module.state_dict(), weights)
    return cfg, model, weights


def _train_opts(out_dir, weights):
    return ["DATA.TRAIN.name", "dummy", "DATA.TEST.name", "dummy", "MODEL.BATCHSIZE", "8", "AUG.TRAIN_SETTING.INPUT_SIZE",
            "(640,640)", "SOLVER.MAX_EPOCH", "1", "SOLVER.NUM_IMAGE_PER_EPOCH", "32",
            "GLOBAL.LOG_INTERVAL", "1", "MODEL.WEIGHTS", weights, "GLOBAL.OUTPUT_DIR", out_dir,
            "GLOBAL.CKPT_SAVE_DIR", os.path.join(out_dir, "ckpt")]


def phase_train(out_dir, weights):
    """det_train on full-width YOLOX-S, 4 steps of 8 images; the matching
    and IoU counts are zeroed just before and read just after. Returns the
    matching launches, the dumped weights and the first step's SimOTA IoU
    arguments (gts, predicted boxes)."""
    from basedet_tpu_torch.layers.common import matcher
    from basedet_tpu_torch.models.det import yolox
    from basedet_tpu_torch.models.det.yolox import YOLOX
    from basedet_tpu_torch.ops.matching_kernel import dynamic_k_matching, dynamic_k_matching_plain
    from basedet_tpu_torch.tools import det_train

    keep_inputs = lambda args, out: [a.clone() for a in args[:3]]
    keep_losses = lambda args, out: {k: float(v.detach()) for k, v in out[1].items()}
    with recording(matcher, "dynamic_k_matching", keep_inputs) as matched, \
            recording(YOLOX, "get_losses", keep_losses) as losses, \
            recording(yolox, "box_iou", lambda args, out: tuple(a.clone() for a in args)) as iou_calls, \
            iou_counted("YOLOX-S det_train"):
        dynamic_k_matching.launches, dynamic_k_matching_plain.calls = 0, 0
        t0 = time.perf_counter()
        trainer = det_train.main(["-f", CONFIG, "--device", "cuda", *_train_opts(out_dir, weights)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, plain_calls = dynamic_k_matching.launches, dynamic_k_matching_plain.calls

    steps = trainer.state.step
    ckpt = os.path.join(out_dir, "ckpt")
    check(steps == 4 and len(losses) == 4, f"det_train took {steps} steps, not 4")
    check(launches == steps, f"the matching kernel launched {launches} times in {steps} steps")
    check(plain_calls == 0, f"the plain matching ran {plain_calls} times on the main path")
    iou = check_iou_counts("YOLOX-S det_train", steps)
    check(all(math.isfinite(v) for step in losses for v in step.values()), f"non-finite losses {losses}")
    for name in ("latest.pt", "epoch_1.pt", "dumped_model.pt"):
        check(os.path.exists(os.path.join(ckpt, name)), f"det_train wrote no {name}")
    size = trainer.model.extra_meter["img_size"]
    check(matched[0][0].shape[2] == MATCH_M_832 and size == 832, "the multiscale resize did not run")
    per_step = "; ".join(", ".join(f"{k.replace('_loss', '')} {v:.4f}" for k, v in step.items())
                         for step in losses)
    log(f"[train] det_train YOLOX-S, 4 steps of 8 images 640x640 resized to {size}x{size} "
        f"(multiscale, RandomState(step // 10)), f32, in {seconds:.2f} s; matching kernel launches "
        f"{launches}, plain calls {plain_calls}; SimOTA's {iou} at {tuple(iou_calls[0][0].shape)} x "
        f"{tuple(iou_calls[0][1].shape)}; lr {trainer.meters['lr'].latest:.4g} = the floor and "
        f"L1 on: a 1-epoch run lies wholly in the 15-epoch no-aug tail; losses per step: {per_step}; "
        f"checkpoints latest.pt, epoch_1.pt, dumped_model.pt written")
    for i, (cost, ious, valid) in enumerate(matched):
        _check_matching(f"train step {i + 1}", cost, ious, valid)
    return launches, os.path.join(ckpt, "dumped_model.pt"), iou_calls[0]


def phase_slice(out_dir, cfg, weights, path="YOLOX-S det_test"):
    """det_test on 8 requests; the NMS and IoU counts are zeroed just before
    and read just after (it reaches no IoU)."""
    from basedet_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain
    from basedet_tpu_torch.tools import det_test

    opts = ["DATA.TEST.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", "(640,640)",
            "GLOBAL.OUTPUT_DIR", out_dir]
    nms_keep.launches, nms_keep_plain.calls = 0, 0
    t0 = time.perf_counter()
    with nms_counts() as seen, iou_counted(path):
        results = det_test.main(["-f", CONFIG, "-w", weights, "--device", "cuda", *opts])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, plain_calls = nms_keep.launches, nms_keep_plain.calls

    with open(os.path.join(out_dir, "predict_coco.json")) as f:
        records = json.load(f)
    check(len(records) >= 1, "det_test gave no detections")
    check(np.isfinite([r["bbox"] + [r["score"]] for r in records]).all(), "non-finite detections")
    check({r["image_id"] for r in records} == set(range(8)), "not every request was answered")
    check(launches > 0, "the NMS kernel was never launched on the main path")
    check(plain_calls == 0, f"the plain NMS ran {plain_calls} times on the main path")
    check(any(k < v for call in seen for v, k in call), "NMS suppressed nothing on the main path")
    iou = check_iou_counts(path, 0)
    log(f"[slice] det_test YOLOX-S (depth {cfg.MODEL.DEPTH_FACTOR}, width {cfg.MODEL.WIDTH_FACTOR}, "
        f"{cfg.DATA.NUM_CLASSES} classes) with det_train's {os.path.basename(weights)} on 8 requests "
        f"of 640x640: {results}, {len(records)} finite detections in {seconds:.2f} s; "
        f"NMS kernel launches {launches}, plain calls {plain_calls}; {iou}; "
        f"NMS kept per image {_kept_range(seen)}")
    return launches


def phase_card_vs_cpu(cfg, model, weights, name="YOLOX-S"):
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.data import build_test_dataloader
    from basedet_tpu_torch.utils.compare import match_detections

    cpu = build_model(cfg, "cpu")
    cpu.load_weights(weights)
    batch = next(iter(build_test_dataloader(cfg)))  # det_test's first request
    batch = {k: batch[k] for k in ("data", "im_info")}
    with torch.inference_mode():
        gpu_head = model.module(model.pre_process(batch)["image"])
        cpu_head = cpu.module(cpu.pre_process(batch)["image"])
    err = max(float((g.cpu() - c).abs().max())
              for gl, cl in zip(gpu_head, cpu_head) for g, c in zip(gl, cl))
    check(err <= HEAD_ATOL, f"head outputs differ between card and CPU by {err}")
    gpu = {k: v.cpu().numpy() for k, v in model.inference(batch).items()}
    ref = {k: v.numpy() for k, v in cpu.inference(batch).items()}
    frac = match_detections(ref, gpu)
    check(np.isfinite(gpu["boxes"]).all() and gpu["valid"].any(), "card detections empty or non-finite")
    check(frac >= 0.95, f"only {frac:.3f} of the CPU's detections matched on the card")
    log(f"[parity] {name} card vs CPU, f32, one 640x640 image: head max |diff| {err:.3e} (tol {HEAD_ATOL}); "
        f"{int(ref['valid'].sum())} CPU / {int(gpu['valid'].sum())} card detections, "
        f"{frac:.4f} matched (label, IoU >= 0.999, |dscore| <= 1e-4)")


AMP_OPTS = {None: [], "bf16": ["TRAINER.AMP.ENABLE", "True"],
            "fused": ["TRAINER.AMP.ENABLE", "True", "TRAINER.AMP.FUSED_BN", "True"]}


def _train_setup(weights, device, batch_size, amp=None, config=CONFIG, extra=()):
    """YOLOX-S (or the YOLOX ``config``, with ``extra`` overrides) in train
    mode with ``weights``, its solver, state and step (f32, or under the bf16
    policy with ``amp`` "bf16" or "fused"), the first synthetic batch of
    ``batch_size`` 640x640 images and the config."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.data import build_train_dataloader
    from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
    from basedet_tpu_torch.solver import YOLOXSolver
    from basedet_tpu_torch.tools import import_config

    cfg = import_config(config)
    cfg.merge(["DATA.TRAIN.name", "dummy", "MODEL.BATCHSIZE", str(batch_size), *AMP_OPTS[amp], *extra])
    model = build_model(cfg, device)
    model.load_weights(weights)
    model.train()
    solver = YOLOXSolver.build(cfg)
    state = TrainState(model, solver, ema=True)
    return (model, solver, state, make_train_step(model, solver, cfg), next(build_train_dataloader(cfg)),
            cfg)


def phase_train_vs_cpu(weights):
    """One train step on the card and on the CPU, same weights and batch.
    The gradient norm is read where the step hands the gradients to the
    solver, before the optimizer (whose CUDA path updates some in place)."""
    def grad_norm(args, out):
        return float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in args[0])))

    runs = {}
    for device in ("cuda", "cpu"):
        model, solver, state, step, batch, _ = _train_setup(weights, device, 2)
        with recording(model, "assign", lambda args, out: out[0].cpu()) as fg, \
                recording(solver, "clip_grads", grad_norm) as norm:
            metrics = step(state, batch)
        stats = {k: v.double().cpu() for k, v in model.module.state_dict().items() if "running" in k}
        runs[device] = ({k: float(v) for k, v in metrics.items() if k != "lr"}, fg[0], norm[0], stats)
    (gpu_losses, gpu_fg, gpu_norm, gpu_stats), (cpu_losses, cpu_fg, cpu_norm, cpu_stats) = \
        runs["cuda"], runs["cpu"]
    stats_rel = max(float(((gpu_stats[k] - v).abs() / v.abs().clamp(min=1.0)).max())
                    for k, v in cpu_stats.items())
    rel = {k: abs(gpu_losses[k] - v) / max(abs(v), 1e-12) for k, v in cpu_losses.items() if v != 0}
    agree = float((gpu_fg == cpu_fg).float().mean())
    norm_rel = abs(gpu_norm - cpu_norm) / cpu_norm
    log(f"[parity] train step card vs CPU, f32, batch 2 of 640x640: losses card "
        f"{', '.join(f'{k} {v:.6f}' for k, v in gpu_losses.items())} / CPU "
        f"{', '.join(f'{k} {v:.6f}' for k, v in cpu_losses.items())}, worst rel diff "
        f"{max(rel.values()):.3e} (tol {LOSS_RTOL}); foreground {int(gpu_fg.sum())} card / "
        f"{int(cpu_fg.sum())} CPU anchors, agreement {agree:.6f} of {gpu_fg.numel()} (min {FG_AGREE}); "
        f"gradient norm {gpu_norm:.6f} card / {cpu_norm:.6f} CPU, rel diff {norm_rel:.3e} "
        f"(tol {GRAD_NORM_RTOL}); new BN running statistics differ by {stats_rel:.3e} of "
        f"max(|value|, 1) (tol {STATS_RTOL})")
    check(all(math.isfinite(v) for v in gpu_losses.values()), "non-finite losses on the card")
    check(max(rel.values()) <= LOSS_RTOL, f"train losses differ between card and CPU: {rel}")
    check(agree >= FG_AGREE, f"only {agree:.6f} of the anchors agree on foreground")
    check(norm_rel <= GRAD_NORM_RTOL, f"gradient norms differ by {norm_rel:.3e}")
    check(stats_rel <= STATS_RTOL, f"BN running statistics differ by {stats_rel:.3e}")


AMP_LABELS = {None: "f32", "bf16": "bf16, fused chain off", "fused": "bf16, fused chain on"}


@contextlib.contextmanager
def plain_iou_callers():
    """RPN targets, R-CNN sampling and SimOTA calling the plain IoU on the card, as they did before
    they went through kernel #10: the routing's "before", for timing."""
    from basedet_tpu_torch.layers.head import rcnn
    from basedet_tpu_torch.models.det import rpn, yolox
    from basedet_tpu_torch.ops.iou_kernel import box_iou_plain

    modules = (rpn, rcnn, yolox)
    saved = [m.box_iou for m in modules]
    for m in modules:
        m.box_iou = box_iou_plain
    try:
        yield
    finally:
        for m, fn in zip(modules, saved):
            m.box_iou = fn


def routing_timing(label, card, **runs):
    """Each of ``runs`` (a train step, or a stage of it that calls the IoU) with its IoUs through
    kernel #10 and through the plain version (the routing's before), in turns (kernel, plain,
    plain, kernel): means of MODEL_REPS runs each (events), and the peak memory of each
    (torch.cuda.max_memory_allocated)."""
    for name, run in runs.items():
        times, peaks = {"kernel": [], "plain": []}, {"kernel": 0, "plain": 0}
        for which in ("kernel", "plain", "plain", "kernel"):
            with plain_iou_callers() if which == "plain" else contextlib.nullcontext():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                times[which].append(cuda_ms(run, reps=MODEL_REPS, warmup=2))
                peaks[which] = max(peaks[which], torch.cuda.max_memory_allocated())
        span = {k: f"{min(v):.3f}-{max(v):.3f}" for k, v in times.items()}
        log(f"[routing] {label}, {name}: IoU through the kernel {span['kernel']} ms, peak "
            f"{peaks['kernel'] / 2**30:.3f} GiB; through the plain version on the card (before the routing) "
            f"{span['plain']} ms, peak {peaks['plain'] / 2**30:.3f} GiB; kernel, plain, plain, kernel | {card}")


def phase_train_timing(weights, card, amp=None, fused_step=None):
    """One train step at batch 8 of 640x640 (input already on the card,
    multiscale pinned), f32 or under the bf16 policy with the fused chain off
    or on (``amp``), as a total and split by prefix: the forward, the
    assignment alone (the matching kernel inside), get_losses (forward,
    assignment, losses), get_losses with backward, the whole step. With the
    chain on, ``fused_step`` (the fused kernels' times summed over one step's
    calls, from ``phase_fused_kernels``) gives their share of the step."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.layers.precision import policy_from_cfg, precision_policy
    from basedet_tpu_torch.ops.fused_bn_kernel import fused_gemm_stats
    from basedet_tpu_torch.ops.matching_kernel import dynamic_k_matching

    model, _, state, step, batch, cfg = _train_setup(weights, "cuda", 8, amp)
    policy = policy_from_cfg(cfg)
    batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    image = model.pre_process(batch, train=True)["image"]

    def forward():
        with full_f32(), precision_policy(*policy):
            model.module(image)

    def losses():
        with full_f32(), precision_policy(*policy):
            return model.get_losses(batch)[0]

    def losses_backward():
        with full_f32():
            losses().backward()

    with recording(model, "assign", lambda args, out: args) as assigned:
        losses()
    launches, fused = dynamic_k_matching.launches, fused_gemm_stats.launches
    t_fwd = cuda_ms(forward, reps=MODEL_REPS, warmup=2)
    t_assign = cuda_ms(lambda: model.assign(*assigned[0]), reps=MODEL_REPS, warmup=2)
    t_loss = cuda_ms(losses, reps=MODEL_REPS, warmup=2)
    t_fb = cuda_ms(losses_backward, reps=MODEL_REPS, warmup=2)
    torch.cuda.reset_peak_memory_stats()
    t_step = cuda_ms(lambda: step(state, batch), reps=MODEL_REPS, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    check(dynamic_k_matching.launches > launches, "train timing ran no matching kernel")
    check((fused_gemm_stats.launches > fused) == (amp == "fused"),
          f"{AMP_LABELS[amp]} train timing made {fused_gemm_stats.launches - fused} fused launches")
    share = ""
    if fused_step is not None:
        kernels = fused_step["fwd"] + fused_step["bwd"]
        share = (f"; the 36 + 36 fused kernel calls {kernels:.3f} ms of it ({kernels / t_step:.3f} of the "
                 f"step, timed alone)")
    log(f"[timing] YOLOX-S {AMP_LABELS[amp]} train step, batch 8 of 640x640: {t_step:.3f} ms per step "
        f"({8000 / t_step:.1f} img/s): forward {t_fwd:.3f} ms, assignment {t_assign:.3f} ms "
        f"(matching kernel inside), losses {t_loss - t_fwd - t_assign:.3f} ms, backward "
        f"{t_fb - t_loss:.3f} ms, SGD+EMA {t_step - t_fb:.3f} ms (parts are differences of means "
        f"of {MODEL_REPS} runs each){share}; peak memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated), input already on the card | {card}")
    if amp is None:
        routing_timing("YOLOX-S f32 train step, batch 8 of 640x640", card,
                       assignment=lambda: model.assign(*assigned[0]), step=lambda: step(state, batch))
    return t_step, lambda: step(state, batch)


# -- fused 1x1-GEMM + BN statistics (kernels #3 and #4) ------------------------------------------

def _bf16_ulp(t):
    """The spacing of bf16 at |t| (t rounded to bf16 first), f32."""
    a = t.float().abs().bfloat16()
    return ((a.view(torch.int16) + 1).view(torch.bfloat16).float() - a.float())


def _fused_signature(terms):
    """(spec, M, K per term, N) of a fused call."""
    from basedet_tpu_torch.ops.fused_bn import flatten_terms

    spec, flat = flatten_terms(terms)
    return spec, flat[0].shape[0], tuple(t[2].shape[0] for t in terms), terms[0][2].shape[1]


def _fused_bytes_ops(terms):
    """Bytes (each input read once, each output written once) and tensor
    operations of one fused forward and one backward call."""
    from basedet_tpu_torch.ops.fused_bn import flatten_terms

    _, flat = flatten_terms(terms)
    M, N = flat[0].shape[0], terms[0][2].shape[1]
    inputs = sum(a.numel() * a.element_size() for a in flat)
    ks = sum(t[2].shape[0] for t in terms)
    m_in = sum(a.numel() * 2 for a in flat if a.dim() == 2 and a.shape[0] == M)
    vectors = sum(a.numel() * 4 for a in flat if a.dim() == 1)
    weights = sum(t[2].numel() for t in terms)
    fwd = (inputs + M * N * 2 + 2 * N * 4, 2 * M * ks * N)
    # backward: inputs, y, dy read, ds, dss read; dx per M-tensor (bf16), dw f32, dscale/dshift f32
    bwd = (inputs + 2 * M * N * 2 + 2 * N * 4 + m_in + weights * 4 + vectors, 4 * M * ks * N)
    return fwd, bwd


def check_fused_case(terms, dy, ds, dss):
    """Kernels #3 and #4 against their plain versions on one call. Every
    output's deviation is divided by its tolerance (``FUSED_SUM_RTOL`` of the
    sum of its terms' magnitudes, propagated, plus one ulp where the output is
    bf16); returns the largest such ratio per output, which must be <= 1, and
    the share of y elements that differ and that differ by more than one
    ulp."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.ops.fused_bn import (_dsilu, _prologue, fused_gemm_stats_backward_plain,
                                                fused_gemm_stats_plain)
    from basedet_tpu_torch.ops.fused_bn_kernel import fused_gemm_stats, fused_gemm_stats_backward

    r = FUSED_SUM_RTOL
    mm = lambda a, b: a.float().abs() @ b.float().abs()
    with torch.no_grad(), full_f32():
        y, s, ss = fused_gemm_stats(terms)
        torch.cuda.synchronize()
        yp, sp, ssp = fused_gemm_stats_plain(terms)
        ops = [t[1] if t[0] == "act" else _prologue(t[1])[0] for t in terms]
        absum = sum(mm(a, t[2]) for a, t in zip(ops, terms))
        tol_y = _bf16_ulp(yp) + r * absum
        ratios = {"y": float(((y.float() - yp.float()).abs() / tol_y).max())}
        yf = yp.float()
        tol_s = tol_y.sum(0) + r * yf.abs().sum(0)
        tol_ss = (2 * yf.abs() * tol_y + tol_y * tol_y).sum(0) + r * (yf * yf).sum(0)
        ratios["s"] = float(((s - sp).abs() / tol_s).max())
        ratios["ss"] = float(((ss - ssp).abs() / tol_ss).max())
        diff = y != yp
        ulps = (y.float() - yp.float()).abs() / _bf16_ulp(yp)
        shares = (float(diff.float().mean()), float((ulps > 1.0001).float().mean()))

        got = fused_gemm_stats_backward(terms, yp, dy, ds, dss)
        torch.cuda.synchronize()
        want = fused_gemm_stats_backward_plain(terms, yp, dy, ds, dss)
        dy16 = (dy.float() + ds + 2.0 * yp.float() * dss).to(torch.bfloat16)
        tols = []  # (name, tolerance) in the order of the cotangents
        for t, a in zip(terms, ops):
            w = t[2]
            dact_err = r * mm(dy16, w.t())  # dy_eff @ w^T summed in another order
            if t[0] == "act":
                tols.append(("dx", _bf16_ulp(want[len(tols)]) + dact_err))
            else:
                _, pres, xfs = _prologue(t[1])
                dact = dy16.float() @ w.float().t()
                for (_, sc, _), pre, xf in zip(t[1], pres, xfs):
                    dsilu = _dsilu(pre).abs()
                    g_abs, g_err = dact.abs() * dsilu, dact_err * dsilu
                    tols.append(("dx", _bf16_ulp(want[len(tols)]) + g_err * sc.abs()))
                    tols.append(("dscale", r * (g_abs * xf.abs()).sum(0) + (g_err * xf.abs()).sum(0) + 1e-30))
                    tols.append(("dshift", r * g_abs.sum(0) + g_err.sum(0) + 1e-30))
            tols.append(("dw", _bf16_ulp(want[len(tols)]) + r * mm(a.t(), dy16)))
        errs = {"y": float((y.float() - yp.float()).abs().max())}
        for (name, tol), g, w in zip(tols, got, want):
            check(g.shape == w.shape and g.dtype == w.dtype, f"fused backward: {name} {g.dtype} "
                                                             f"{tuple(g.shape)} vs {w.dtype} {tuple(w.shape)}")
            d = (g.float() - w.float()).abs()
            ratios[name] = max(ratios.get(name, 0.0), float((d / tol).max()))
            errs[name] = max(errs.get(name, 0.0), float(d.max()))
        errs["s"], errs["ss"] = float((s - sp).abs().max()), float((ss - ssp).abs().max())
    return ratios, shares, errs


def check_fused_cases(tag, cases):
    """``check_fused_case`` on each (name, terms, (dy, ds, dss)) of cases,
    a line each; fails if any output lies beyond its tolerance. Returns the
    largest |kernel - plain| per output."""
    worst, worst_err, failed = {}, {}, []
    for name, terms, cts in cases:
        ratios, (share, share_1), errs = check_fused_case(terms, *cts)
        for k, v in ratios.items():
            worst[k] = max(worst.get(k, 0.0), v)
            worst_err[k] = max(worst_err.get(k, 0.0), errs[k])
        log(f"[{tag}] {name:42s} y differs on {share:.5f} of elements ({share_1:.6f} by more than 1 ulp); "
            f"max |kernel - plain| / tolerance: " + ", ".join(f"{k} {errs[k]:.2e}/{v:.3f}" for k, v in ratios.items()))
        if any(v > 1.0 for v in ratios.values()):
            failed.append(name)
    check(not failed, f"fused kernels differ from their plain versions beyond tolerance on {failed}")
    log(f"[{tag}] {len(cases)} cases within tolerance ({FUSED_SUM_RTOL:.3e} of the sums of magnitudes + 1 bf16 "
        f"ulp); worst max |kernel - plain| / tolerance: "
        + ", ".join(f"{k} {worst_err[k]:.3e}/{v:.3f}" for k, v in worst.items()))
    return worst_err


def fused_backward_calls(first_per_shape):
    """Record the fused backward calls as (signature, terms, (dy, ds, dss)),
    cloned: every call's, or with ``first_per_shape`` only the first of
    each signature's (later ones as (signature, None, None))."""
    from basedet_tpu_torch.ops import fused_bn_kernel

    seen = set()

    def keep(args, out):  # _backward(terms, M, N, device, y, dy, ds, dss)
        sig = _fused_signature(args[0])
        if first_per_shape and sig in seen:
            return sig, None, None
        seen.add(sig)
        return sig, _detached_terms(args[0]), tuple(a.detach().clone() for a in args[5:8])

    return recording(fused_bn_kernel, "_backward", keep)


def _case_name(sig):
    return (f"{'+'.join(str(x[1] if x[0] == 'raw' else 'act') for x in sig[0])} M={sig[1]} "
            f"K={'+'.join(map(str, sig[2]))} N={sig[3]}")


def _fused_errs(worst_err):
    """The kernel report's max_abs_err of the forward and the backward."""
    fwd = max(worst_err[k] for k in ("y", "s", "ss"))
    return fwd, max(v for k, v in worst_err.items() if k not in ("y", "s", "ss"))


def _random_fused_terms(gen, spec, M, K, N):
    terms = []
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    for s in spec:
        w = (randn(K, N) * K ** -0.5).bfloat16()
        if s == "act":
            terms.append(("act", randn(M, K).bfloat16(), w))
        else:
            terms.append(("raw", [(randn(M, K).bfloat16(), torch.rand(K, device="cuda", generator=gen) + 0.5,
                                   randn(K) * 0.1) for _ in range(s)], w))
    return terms


def _fused_cotangents(gen, M, N, zero=False):
    if zero:
        return (torch.randn(M, N, device="cuda", generator=gen).bfloat16(),
                torch.zeros(N, device="cuda"), torch.zeros(N, device="cuda"))
    return (torch.randn(M, N, device="cuda", generator=gen).mul(1e-2).bfloat16(),
            torch.randn(N, device="cuda", generator=gen) * 1e-4,
            torch.randn(N, device="cuda", generator=gen) * 1e-5)


def _detached_terms(terms):
    return [(t[0], t[1].detach().clone() if t[0] == "act" else
             [tuple(a.detach().clone() for a in raw) for raw in t[1]], t[2].detach().clone()) for t in terms]


def _grad_terms(terms):
    """Copies of terms whose tensors need gradients, as a train step's do."""
    copy = lambda a: a.detach().clone().requires_grad_(True)
    return [(t[0], copy(t[1]) if t[0] == "act" else [tuple(map(copy, raw)) for raw in t[1]], copy(t[2]))
            for t in terms]


def _fused_repeats(terms, cts):
    """The outputs on which two launches of the fused forward on terms, or
    two of the backward on its y and the cotangents cts, differ in their bits:
    "y", "s", "ss", or "d<i>" for the backward's i-th cotangent."""
    from basedet_tpu_torch.ops.fused_bn_kernel import fused_gemm_stats, fused_gemm_stats_backward

    bits = lambda a: a.view(torch.int16) if a.dtype == torch.bfloat16 else a.view(torch.int32)
    with torch.no_grad():
        first = [a.clone() for a in fused_gemm_stats(terms)]
        second = fused_gemm_stats(terms)
        back = [[a.clone() for a in fused_gemm_stats_backward(terms, first[0], *cts)] for _ in range(2)]
    names = ["y", "s", "ss", *(f"d{i}" for i in range(len(back[0])))]
    return [n for n, a, b in zip(names, [*first, *back[0]], [*second, *back[1]]) if not torch.equal(bits(a), bits(b))]


def fused_step_calls(weights):
    """The 36 fused calls of one bf16 train forward of full-width YOLOX-S at
    batch 8 of 640x640, in order: (signature, detached terms, y)."""
    from basedet_tpu_torch.layers.blocks import csp_fused
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.layers.precision import precision_policy

    model, _, _, _, batch, _ = _train_setup(weights, "cuda", 8, amp="fused")
    batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    keep = lambda args, out: (_fused_signature(args[0]), _detached_terms(args[0]), out[0].detach())
    with recording(csp_fused, "fused_gemm_stats", keep) as calls, full_f32(), \
            precision_policy(torch.bfloat16, True):
        model.get_losses(batch)[0].backward()
    check(len(calls) == 36, f"one YOLOX-S forward made {len(calls)} fused calls, not 36")
    return calls


def fused_backward_library(terms, y, dy, ds, dss):
    """Kernel #4's yardstick, which the port never calls: per term
    ``torch.matmul(dy_eff16, w^T)`` and ``torch.matmul(a16^T, dy_eff16)`` on
    bf16 operands computed beforehand (dy_eff and a raw term's prologue), as
    #3's yardstick precomputes its operand."""
    from basedet_tpu_torch.ops.fused_bn import _prologue

    dy16 = (dy.float() + ds + 2.0 * y.float() * dss).to(torch.bfloat16)
    ops = [(t[1] if t[0] == "act" else _prologue(t[1])[0], t[2]) for t in terms]

    def library():
        for a, w in ops:
            torch.matmul(dy16, w.t())
            torch.matmul(a.t(), dy16)

    return library


def fused_backward_replay(calls, gen, card):
    """The step's backward calls as training makes them: each call's forward
    run once through the autograd Function on copies of its inputs that need
    gradients, then the 36 backwards replayed by one ``torch.autograd.grad``
    pass over all of them, on random cotangents of y, s and ss, as a train
    step's backward runs them (the autograd engine, in reverse order of the
    forwards; ``_FusedGemmStats.backward``; the kernels): events time, the
    device time of every operation they run and operations per call
    (profiler), host time per call. Then kernel #4's yardstick on the same
    calls in order: two ``torch.matmul`` a term, events and device time."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.ops.fused_bn import flatten_terms
    from basedet_tpu_torch.ops.fused_bn_kernel import fused_gemm_stats

    outs, leaves, cts, yardsticks = [], [], [], []
    with full_f32():
        for sig, terms, _ in calls:
            train_terms = _grad_terms(terms)
            leaves += flatten_terms(train_terms)[1]
            outs += fused_gemm_stats(train_terms)
            cts += _fused_cotangents(gen, sig[1], sig[3])
            yardsticks.append(fused_backward_library(terms, outs[-3].detach(), *cts[-3:]))

    def replay():
        torch.autograd.grad(outs, leaves, cts, retain_graph=True)

    def library():
        for fn in yardsticks:
            fn()

    with full_f32():
        ms = cuda_ms(replay, reps=20, warmup=3)
        device, ops, names = device_kernels(replay, 5)
        host, host_text = host_us(replay, len(calls))
    with torch.no_grad(), full_f32():
        library_ms = cuda_ms(library, reps=20, warmup=3)
        library_device = device_kernels(library, 5)[0]
    top = ", ".join(f"{n} {v:.4f}" for n, v in sorted(names.items(), key=lambda kv: -kv[1])[:4])
    log(f"[fused] the step's 36 backward calls, as training makes them (one torch.autograd.grad pass through the "
        f"autograd Function): events {ms:.4f} ms, device time of everything they run {device:.4f} ms in "
        f"{ops / len(calls):.2f} operations per call (profiler; {top}), host {host_text}; two torch.matmul a "
        f"term on the same calls in order: events {library_ms:.4f} ms, device {library_device:.4f} ms | {card}")
    return dict(ms=ms, device_ms=device, ops_per_call=ops / len(calls), host_us=host, library_ms=library_ms,
                library_device_ms=library_device, kernels={n: round(v, 5) for n, v in names.items()})


# phase 9a's cases where kernel #4 streams w's rows: its shared memory would not hold them with
# dy_eff over all of N
STREAMED_CASES = ("YOLOX-M dark5 conv3", "YOLOX-L dark5 conv3", "YOLOX-X dark5 conv3", "16 raw N=640")


def fused_streamed_timing(cases, card):
    """Kernel #4 on the cases where it streams w (checked against the plan):
    events and device time a call (profiler), the plain version, the
    yardstick and the bound."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.ops.fused_bn import flatten_terms, fused_gemm_stats_backward_plain
    from basedet_tpu_torch.ops.fused_bn_kernel import MAX_SMEM, backward_smem, fused_gemm_stats, \
        fused_gemm_stats_backward

    check(len(cases) == len(STREAMED_CASES), f"phase 9a lacks some of {STREAMED_CASES}")
    for name, terms, (dy, ds, dss) in cases:
        spec = flatten_terms(terms)[0]
        N = terms[0][2].shape[1]
        check(backward_smem(N, spec, 2) > MAX_SMEM, f"kernel #4 would keep w resident on {name}")
        with torch.no_grad(), full_f32():
            y = fused_gemm_stats(terms)[0]
            call = lambda: fused_gemm_stats_backward(terms, y, dy, ds, dss)
            ms = cuda_ms(call, reps=20, warmup=3)
            device = device_kernels(call, 10)[0]
            plain = cuda_ms(lambda: fused_gemm_stats_backward_plain(terms, y, dy, ds, dss), reps=5, warmup=1)
            library = cuda_ms(fused_backward_library(terms, y, dy, ds, dss), reps=20, warmup=3)
        log(f"[fused] backward, w streamed, {name} (M={y.shape[0]} K={terms[0][2].shape[0]} N={N}): events {ms:.4f} "
            f"ms, device {device:.4f} ms (profiler), plain {plain:.4f}, two torch.matmul a term {library:.4f}, "
            f"bound {bound(*_fused_bytes_ops(terms)[1], PEAK_BF16_PER_S)[0]:.4f} | {card}")


def phase_fused_kernels(weights, card):
    """Kernels #3 and #4 against their plain versions: on the fused calls of
    one bf16 train forward of full-width YOLOX-S at batch 8 of 640x640 (real
    activations, every distinct shape) and on edge cases; then each distinct
    shape timed, kernel, plain version and the library yardsticks, and summed
    over the calls of one step; then the step's forward and backward calls
    replayed in order."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.ops.fused_bn import _prologue, fused_gemm_stats_backward_plain, fused_gemm_stats_plain
    from basedet_tpu_torch.ops.fused_bn_kernel import _card, forward_plan, fused_gemm_stats, fused_gemm_stats_backward

    calls = fused_step_calls(weights)
    first = {}
    for sig, terms, y in calls:
        first.setdefault(sig, terms)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cases = [(f"yolox {_case_name(sig)}", terms, _fused_cotangents(gen, sig[1], sig[3]))
             for sig, terms in first.items()]
    for name, spec, M, K, N in (("M=1037 act", ("act",), 1037, 64, 32), ("M=1037 1 raw", (1,), 1037, 128, 64),
                                ("2 raw", (2,), 4096, 64, 64), ("4 raw", (4,), 4096, 128, 64),
                                ("act + raw", ("act", 1), 2048, 128, 128), ("4 raw + 1 raw", (4, 1), 3000, 256, 512),
                                ("N=512 K=512", ("act",), 3200, 512, 512), ("K=24 N=40", (2,), 777, 24, 40),
                                # conv3's left term at YOLOX-M's depth (dark3: n = 6, so 7 raw inputs) and
                                # YOLOX-X's (dark4: n = 12, so 13), at their widths and batch 8 of 640x640
                                ("7 raw, YOLOX-M dark3", (7,), 8 * 80 * 80, 96, 192),
                                ("13 raw, YOLOX-X dark4", (13,), 8 * 40 * 40, 320, 640),
                                # the strip kernels' edges: one row, a ragged strip, a strip and a
                                # row; one panel of 64 columns, mostly padding
                                ("M=1 act", ("act",), 1, 32, 64), ("M=127 2 raw", (2,), 127, 32, 64),
                                ("M=129 act + raw", ("act", 1), 129, 64, 128),
                                ("N=8 K=8 act", ("act",), 300, 8, 8), ("N=8 K=8 3 raw", (3,), 129, 8, 8),
                                # where the backward streams w's rows: conv3 of the dark5 CSP layer of
                                # YOLOX-M, -L and -X at batch 8 of 640x640 (N = 1024 x width), and a raw
                                # term of 16 inputs, the most a term takes, at N = 640
                                ("YOLOX-M dark5 conv3", (1, 1), 3200, 384, 768),
                                ("YOLOX-L dark5 conv3", (1, 1), 3200, 512, 1024),
                                ("YOLOX-X dark5 conv3", (1, 1), 3200, 640, 1280),
                                ("16 raw N=640", (16,), 12800, 320, 640)):
        cases.append((name, _random_fused_terms(gen, spec, M, K, N), _fused_cotangents(gen, M, N)))
    M, K, N = 5000, 96, 64
    cases.append(("ds = dss = 0", _random_fused_terms(gen, (1, 1), M, K, N), _fused_cotangents(gen, M, N, zero=True)))
    worst_err = check_fused_cases("fused", cases)
    differ = [(name, d) for name, terms, cts in cases if (d := _fused_repeats(terms, cts))]
    check(not differ, f"two runs of the fused kernels differ on {differ}")
    log(f"[fused] two runs of the forward kernel bit-equal in y, s and ss, and of the backward in every "
        f"cotangent, on all {len(cases)} cases")
    fused_streamed_timing([c for c in cases if c[0] in STREAMED_CASES], card)

    times = {}
    for sig, terms in first.items():
        dy, ds, dss = _fused_cotangents(gen, sig[1], sig[3])
        with torch.no_grad(), full_f32():
            y = fused_gemm_stats(terms)[0]
            a_cat = torch.cat([t[1] if t[0] == "act" else _prologue(t[1])[0] for t in terms], 1)
            w_cat = torch.cat([t[2] for t in terms], 0)

            def library():
                yl = torch.matmul(a_cat, w_cat).float()
                return yl.sum(0), (yl * yl).sum(0)

            times[sig] = dict(
                plain=cuda_ms(lambda: fused_gemm_stats_plain(terms), reps=5, warmup=1),
                library=cuda_ms(library, reps=20, warmup=3),
                bwd=cuda_ms(lambda: fused_gemm_stats_backward(terms, y, dy, ds, dss), reps=20, warmup=3),
                bwd_library=cuda_ms(fused_backward_library(terms, y, dy, ds, dss), reps=20, warmup=3),
                bwd_plain=cuda_ms(lambda: fused_gemm_stats_backward_plain(terms, y, dy, ds, dss), reps=5, warmup=1))
        with full_f32():
            train_terms = _grad_terms(terms)
            times[sig]["fwd"] = cuda_ms(lambda: fused_gemm_stats(train_terms), reps=20, warmup=3)
        (fb, fo), (bb, bo) = _fused_bytes_ops(terms)
        times[sig]["bound"] = bound(fb, fo, PEAK_BF16_PER_S)[0]
        times[sig]["bwd_bound"] = bound(bb, bo, PEAK_BF16_PER_S)[0]
        t = times[sig]
        n = sum(1 for c in calls if c[0] == sig)
        plan = forward_plan(sig[1], sig[3], *_card(torch.cuda.current_device()))
        log(f"[fused] {n} x spec {sig[0]} M={sig[1]} K={sig[2]} N={sig[3]} (forward: {plan[0]} panels, "
            f"grid {plan[1]} x {plan[2]}): forward kernel {t['fwd']:.4f} ms "
            f"(bound {t['bound']:.4f}, plain {t['plain']:.4f}, torch.matmul + column sums {t['library']:.4f}); "
            f"backward kernel {t['bwd']:.4f} ms (bound {t['bwd_bound']:.4f}, plain {t['bwd_plain']:.4f}, "
            f"two torch.matmul a term {t['bwd_library']:.4f}) | {card}")
    step = {k: sum(times[c[0]][k] for c in calls) for k in ("fwd", "plain", "library", "bwd", "bwd_plain",
                                                             "bwd_library", "bound", "bwd_bound")}
    step_calls = [_grad_terms(c[1]) for c in calls]

    def replay():
        for terms in step_calls:
            fused_gemm_stats(terms)

    # as det_train --amp calls the kernel: inputs that need gradients, gradients on, each call recorded
    # by autograd; then with gradients off, through the same autograd Function
    with full_f32():
        replay_ms = cuda_ms(replay, reps=20, warmup=3)
        device = device_ms(replay, 5, ("fwd_kernel",))["fwd_kernel"]
        host = host_us(replay, len(step_calls))[1]
    with torch.no_grad(), full_f32():
        replay_nograd_ms = cuda_ms(replay, reps=20, warmup=3)
        host_nograd = host_us(replay, len(step_calls))[1]
    log(f"[fused] the step's 36 forward calls in order, as training makes them (gradients on): events "
        f"{replay_ms:.4f} ms, device time of fwd_kernel {device:.4f} ms (profiler), host {host}; gradients off: "
        f"events {replay_nograd_ms:.4f} ms, host {host_nograd}; bound {step['bound']:.4f} ms, torch.matmul + "
        f"column sums {step['library']:.4f} ms | {card}")
    replay_bwd = fused_backward_replay(calls, gen, card)
    check(replay_bwd["ops_per_call"] <= 2.0, f"the fused backward ran {replay_bwd['ops_per_call']:.2f} device "
                                             f"operations a call, not at most 2")
    fwd_bytes = sum(_fused_bytes_ops(c[1])[0][0] for c in calls)
    bwd_bytes = sum(_fused_bytes_ops(c[1])[1][0] for c in calls)
    log(f"[fused] per train step at batch 8 of 640x640 (36 calls each): forward kernels {step['fwd']:.3f} ms "
        f"(bound {step['bound']:.4f} ms: {fwd_bytes / 1e9:.3f} GB; plain {step['plain']:.3f}, torch.matmul + "
        f"column sums {step['library']:.3f}); backward kernels {step['bwd']:.3f} ms (bound {step['bwd_bound']:.4f} "
        f"ms: {bwd_bytes / 1e9:.3f} GB; plain {step['bwd_plain']:.3f}, two torch.matmul a term "
        f"{step['bwd_library']:.3f}) | {card}")
    by = [[bound(*_fused_bytes_ops(c[1])[i], PEAK_BF16_PER_S) for c in calls] for i in (0, 1)]
    bound_by = ["bytes" if sum(t for t, b in bs if b == "bytes") >= sum(t for t, _ in bs) / 2 else "operations"
                for bs in by]
    fwd_err, bwd_err = _fused_errs(worst_err)
    fwd = dict(max_abs_err=fwd_err, ms=step["fwd"], plain_ms=step["plain"],
               bound_ms=step["bound"], bound_by=bound_by[0], library_ms=step["library"])
    bwd = dict(max_abs_err=bwd_err, ms=step["bwd"], plain_ms=step["bwd_plain"], bound_ms=step["bwd_bound"],
               bound_by=bound_by[1], library_ms=step["bwd_library"])
    return fwd, bwd, step


def phase_train_amp(out_dir, weights):
    """det_train --amp TRAINER.AMP.FUSED_BN True on full-width YOLOX-S, 4
    steps of 8 images; the fused-kernel and matching counts are zeroed just
    before and read just after. Then kernels #3 and #4 are held to their
    plain versions on the first backward call of each distinct shape of the
    run (832x832 after the multiscale resize): its inputs and its cotangents
    as the step gave them. Returns the launches, the largest |kernel - plain|
    per output and the dumped weights."""
    from basedet_tpu_torch.layers.blocks import csp_fused
    from basedet_tpu_torch.layers.precision import compute_dtype
    from basedet_tpu_torch.models.det.yolox import YOLOX
    from basedet_tpu_torch.ops.fused_bn import fused_gemm_stats_backward_plain, fused_gemm_stats_plain
    from basedet_tpu_torch.ops.fused_bn_kernel import fused_gemm_stats, fused_gemm_stats_backward
    from basedet_tpu_torch.ops.matching_kernel import dynamic_k_matching, dynamic_k_matching_plain
    from basedet_tpu_torch.tools import det_train

    ckpt = os.path.join(out_dir, "amp_ckpt")
    opts = [*_train_opts(out_dir, weights), "GLOBAL.CKPT_SAVE_DIR", ckpt, "TRAINER.AMP.FUSED_BN", "True"]
    kernels = (fused_gemm_stats, fused_gemm_stats_backward, dynamic_k_matching)
    plains = (fused_gemm_stats_plain, fused_gemm_stats_backward_plain, dynamic_k_matching_plain)
    keep_losses = lambda args, out: {k: float(v.detach()) for k, v in out[1].items()}
    with recording(YOLOX, "get_losses", keep_losses) as losses, \
            recording(csp_fused, "fused_gemm_stats", lambda args, out: _fused_signature(args[0])[1]) as rows, \
            fused_backward_calls(first_per_shape=True) as backward, iou_counted("YOLOX-S det_train --amp"):
        for fn in kernels:
            fn.launches = 0
        for fn in plains:
            fn.calls = 0
        t0 = time.perf_counter()
        trainer = det_train.main(["-f", CONFIG, "--device", "cuda", "--amp", *opts])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = [fn.launches for fn in kernels]
        plain_calls = [fn.calls for fn in plains]

    steps = trainer.state.step
    size = trainer.model.extra_meter["img_size"]
    check(steps == 4 and len(losses) == 4, f"det_train --amp took {steps} steps, not 4")
    check(launches == [36 * steps, 36 * steps, steps],
          f"fused forward, fused backward and matching kernels launched {launches} times in {steps} steps")
    check(plain_calls == [0, 0, 0], f"plain versions ran {plain_calls} times on the main path")
    iou = check_iou_counts("YOLOX-S det_train --amp", steps)
    check(all(math.isfinite(v) for step in losses for v in step.values()), f"non-finite losses {losses}")
    check(compute_dtype() is None, "the bf16 policy outlived the train step")
    check(all(p.dtype == torch.float32 for p in trainer.model.module.parameters()), "parameters left f32")
    check(size == 832 and rows[0] == 8 * (832 // 4) ** 2, f"the multiscale resize did not run ({size}, {rows[0]})")
    for name in ("latest.pt", "epoch_1.pt", "dumped_model.pt"):
        check(os.path.exists(os.path.join(ckpt, name)), f"det_train --amp wrote no {name}")
    per_step = "; ".join(", ".join(f"{k.replace('_loss', '')} {v:.4f}" for k, v in step.items())
                         for step in losses)
    log(f"[amp-train] det_train --amp TRAINER.AMP.FUSED_BN True, YOLOX-S, 4 steps of 8 images 640x640 "
        f"resized to {size}x{size}, bf16 policy, in {seconds:.2f} s; launches: fused forward {launches[0]}, "
        f"fused backward {launches[1]} (36 per step, the first on {rows[0]} rows), matching {launches[2]}; "
        f"plain calls {plain_calls}; SimOTA's {iou} (f32 inputs under the bf16 policy); losses per step: "
        f"{per_step}; checkpoints written")
    rows_832 = {8 * (size // stride) ** 2 for stride in (4, 8, 16, 32)}  # the CSP layers' strides
    check(len(backward) == launches[1] and {sig[1] for sig, _, _ in backward} == rows_832,
          f"the fused backward calls have shapes {[sig for sig, _, _ in backward]}")
    worst_err = check_fused_cases("amp-fused", [(f"det_train step 1 {_case_name(sig)}", terms, cts)
                                                for sig, terms, cts in backward if terms is not None])
    return launches, worst_err, os.path.join(ckpt, "dumped_model.pt")


def phase_amp_train_vs_cpu(weights):
    """One bf16 train step with the fused chain, same weights and batch of 2,
    on the CPU (plain versions), on the card (kernels, twice) and on the card
    with the plain versions in the kernels' place. The kernels are held to
    their plain versions on each of the card step's 36 calls, with its
    inputs and cotangents (FUSED_SUM_RTOL). Then foreground on each device's
    own assignment, and on the CPU's assignment the losses, gradients and BN
    running statistics of the card's step against its plain-version step and
    against the CPU's, within the AMP_* tolerances; an f32 step on the CPU
    measures how far bf16 itself turns the gradient. Returns the largest
    |kernel - plain| per output of the 36 calls."""
    from unittest import mock

    from basedet_tpu_torch.ops import fused_bn_kernel
    from basedet_tpu_torch.ops.fused_bn import fused_gemm_stats_backward_plain, fused_gemm_stats_plain, unflatten_terms

    grads = lambda args, out: [p.grad.detach().double().cpu().clone() for p in args[0]]
    plain = {"_launch_forward": lambda call: fused_gemm_stats_plain(unflatten_terms(call.spec, call.flat)),
             "_launch_backward": lambda terms, M, N, device, *cts: fused_gemm_stats_backward_plain(terms, *cts)}
    counters = (fused_bn_kernel.fused_gemm_stats, fused_bn_kernel.fused_gemm_stats_backward,
                fused_gemm_stats_plain, fused_gemm_stats_backward_plain)
    runs, assigned, calls = {}, None, None
    for run, device, amp in (("cpu", "cpu", "fused"), ("card", "cuda", "fused"), ("card plain", "cuda", "fused"),
                             ("card again", "cuda", "fused"), ("cpu f32", "cpu", None)):
        model, solver, state, step, batch, _ = _train_setup(weights, device, 2, amp=amp)
        t0 = time.perf_counter()
        shared = None if assigned is None else lambda args: tuple(t.to(args[0].device) for t in assigned)
        before = [getattr(c, "launches", getattr(c, "calls", 0)) for c in counters]
        with contextlib.ExitStack() as stack:
            own = stack.enter_context(recording(model, "assign", lambda args, out: out, shared))
            g = stack.enter_context(recording(solver, "clip_grads", grads))
            if run == "card":
                calls = stack.enter_context(fused_backward_calls(first_per_shape=False))
            if run == "card plain":
                for name, fn in plain.items():
                    stack.enter_context(mock.patch.object(fused_bn_kernel, name, fn))
            metrics = step(state, batch)
        seconds = time.perf_counter() - t0
        counts = [getattr(c, "launches", getattr(c, "calls", 0)) - b for c, b in zip(counters, before)]
        want = {"cpu": [0, 0, 36, 36], "card": [36, 36, 0, 0], "card plain": [0, 0, 36, 36],
                "card again": [36, 36, 0, 0], "cpu f32": [0] * 4}
        check(counts == want[run], f"the {run} step made {counts} fused kernel launches and plain calls")
        if assigned is None:
            assigned = tuple(t.detach().cpu() for t in own[0])
        stats = {k: v.double().cpu() for k, v in model.module.state_dict().items() if "running" in k}
        runs[run] = ({k: float(v) for k, v in metrics.items() if k != "lr"}, own[0][0].cpu(), g[0], stats, seconds)
    worst_err = check_fused_cases("amp-parity", [(f"card step call {i + 1} {_case_name(sig)}", terms, cts)
                                                 for i, (sig, terms, cts) in enumerate(calls)])

    norm = lambda g: math.sqrt(sum(float((t * t).sum()) for t in g))
    dist = lambda a, b: norm([x - y for x, y in zip(a, b)]) / norm(b)
    cos = lambda a, b: sum(float((x * y).sum()) for x, y in zip(a, b)) / (norm(a) * norm(b) or 1.0)
    loss_rel = lambda a, b: max(abs(a[k] - v) / abs(v) for k, v in b.items() if v != 0)
    stats_rel = lambda a, b: max(float(((a[k] - v).abs() / v.abs().clamp(min=1.0)).max()) for k, v in b.items())
    (cpu_losses, cpu_fg, cpu_g, cpu_stats, cpu_s), (gpu_losses, gpu_fg, gpu_g, gpu_stats, _), \
        (plain_losses, _, plain_g, plain_stats, _), (_, _, again_g, _, _), (f32_losses, _, f32_g, _, _) = \
        runs.values()
    agree = float((gpu_fg == cpu_fg).float().mean())
    bf16_cos = cos(cpu_g, f32_g)
    pairs = {"kernels vs plain versions on the card": (plain_losses, plain_g, plain_stats),
             "card vs CPU": (cpu_losses, cpu_g, cpu_stats)}
    seen = {name: dict(losses=loss_rel(gpu_losses, l), cos=cos(gpu_g, g), dist=dist(gpu_g, g),
                       norm=abs(norm(gpu_g) - norm(g)) / norm(g), stats=stats_rel(gpu_stats, st))
            for name, (l, g, st) in pairs.items()}
    log(f"[amp-parity] bf16 train step with the fused chain, batch 2 of 640x640, on the card with the kernels, on "
        f"the card with the plain versions in their place, and on the CPU (plain versions, {cpu_s:.1f} s): each "
        f"device's own assignment: foreground {int(gpu_fg.sum())} card / {int(cpu_fg.sum())} CPU anchors, agreement "
        f"{agree:.6f} of {gpu_fg.numel()} (min {AMP_FG_AGREE}); on the CPU's assignment: losses card "
        f"{', '.join(f'{k} {v:.6f}' for k, v in gpu_losses.items())} / card plain "
        f"{', '.join(f'{k} {v:.6f}' for k, v in plain_losses.items())} / CPU "
        f"{', '.join(f'{k} {v:.6f}' for k, v in cpu_losses.items())}; gradient norm {norm(gpu_g):.6f} card / "
        f"{norm(plain_g):.6f} card plain / {norm(cpu_g):.6f} CPU / {norm(f32_g):.6f} CPU f32; the kernels' step run "
        f"twice: |g - g_again| / |g_again| {dist(gpu_g, again_g):.3e}; bf16 itself, the CPU's bf16 step against its "
        f"f32 step: losses {loss_rel(cpu_losses, f32_losses):.3e}, gradient cosine {bf16_cos:.4f}, |g_bf16 - g_f32| "
        f"/ |g_f32| {dist(cpu_g, f32_g):.3e}")
    for name, d in seen.items():
        log(f"[amp-parity] {name}: losses {d['losses']:.3e} (tol {AMP_LOSS_RTOL}), gradient cosine {d['cos']:.4f} "
            f"(min bf16's own {bf16_cos:.4f}), |g - g_other| / |g_other| {d['dist']:.3e}, gradient norm "
            f"{d['norm']:.3e}, BN running statistics {d['stats']:.3e} of max(|value|, 1) (tol {AMP_STATS_RTOL})")
    check(all(math.isfinite(v) for v in gpu_losses.values()), "non-finite bf16 losses on the card")
    check(agree >= AMP_FG_AGREE, f"only {agree:.6f} of the anchors agree on foreground under bf16")
    for name, d in seen.items():
        check(d["losses"] <= AMP_LOSS_RTOL, f"{name}: bf16 train losses differ by {d['losses']:.3e}")
        check(d["cos"] >= bf16_cos, f"{name}: the gradient turned further ({d['cos']:.4f}) than bf16's own "
                                    f"{bf16_cos:.4f}")
        check(d["stats"] <= AMP_STATS_RTOL, f"{name}: BN running statistics differ by {d['stats']:.3e}")
    return worst_err


def _timing_batch(bs, size=(640, 640)):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    h, w = size
    data = torch.rand(bs, h, w, 3, device="cuda", generator=gen) * 255
    info = torch.tensor([[h, w, h, w, 0]], dtype=torch.float32, device="cuda").repeat(bs, 1)
    return {"data": data, "im_info": info}


def phase_timing(model, card):
    from basedet_tpu_torch.ops.nms_kernel import nms_keep

    totals = {}
    for bs, reps in ((1, 15), (32, 4)):
        batch = _timing_batch(bs)
        info = batch["im_info"]
        total = cuda_ms(lambda: model.inference(batch), reps=reps, warmup=3)
        image = model.pre_process(batch)["image"]
        with torch.inference_mode():
            fwd = cuda_ms(lambda: model.module(image), reps=reps, warmup=2)
            head = model.module(image)
            post = cuda_ms(lambda: model.post_process(*head, info), reps=reps, warmup=2)
        with nms_counts() as seen:
            model.inference(batch)
        totals[bs] = total
        log(f"[timing] YOLOX-S f32 640x640 batch {bs}: {total:.3f} ms per batch "
            f"({1000 * bs / total:.1f} img/s; network {fwd:.3f} ms, decode+top-k+NMS {post:.3f} ms; "
            f"NMS kept per image {_kept_range(seen)}), input already on the card | {card}")
    check(nms_keep.launches > 0, "timing ran no NMS kernel")
    return totals


def phase_profile(card, out_dir, runs):
    """torch.profiler over a few calls of each run (name, label, fn, calls,
    unprofiled ms): device kernel time per call against the profiled wall
    time, and against the unprofiled time of the timing phases (the profiler
    slows the host)."""
    from torch.profiler import ProfilerActivity

    os.makedirs(out_dir, exist_ok=True)
    for name, label, fn, iters, unprofiled in runs:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with padded_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1000 / iters
        averages = prof.key_averages()
        key = "self_device_time_total" if hasattr(averages[0], "self_device_time_total") else "self_cuda_time_total"
        kernels = sorted((e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: -getattr(e, key))
        busy = sum(getattr(e, key) for e in kernels) / 1000 / iters
        check(busy > 0, "the profiler saw no device time")
        path = os.path.join(out_dir, f"profile_{name}.txt")
        with open(path, "w") as f:
            f.write(f"{label}, {iters} calls | {card}\n")
            f.write(averages.table(sort_by=key, row_limit=60, max_name_column_width=90))
        top = ", ".join(f"{e.key[:48]} {getattr(e, key) / 1000 / iters:.3f} ms" for e in kernels[:6])
        log(f"[profile] {label}: {sum(e.count for e in kernels) / iters:.0f} device kernels per "
            f"call, busy {busy:.3f} ms of {wall:.3f} ms profiled wall (idle share {1 - busy / wall:.3f}; "
            f"{1 - busy / unprofiled:.3f} against the unprofiled {unprofiled:.3f} ms) -> {path}")
        log(f"[profile]   largest: {top}")


def _proposal_rois(rng, B, R):
    """(B, R, 4) proposal-like boxes on the 800x1333 image: sqrt(area)
    log-uniform in 8-800 px, aspect 1/2-2, clipped to the image; a tenth are
    zero-area padding, as the RPN pads its empty slots."""
    h, w = FRCNN_IMAGE
    side = np.exp(rng.uniform(np.log(8), np.log(800), (B, R)))
    ar = np.exp(rng.uniform(np.log(0.5), np.log(2.0), (B, R)))
    bw, bh = side * np.sqrt(ar), side / np.sqrt(ar)
    cx, cy = rng.uniform(0, w, (B, R)), rng.uniform(0, h, (B, R))
    rois = np.stack([np.clip(cx - bw / 2, 0, w), np.clip(cy - bh / 2, 0, h),
                     np.clip(cx + bw / 2, 0, w), np.clip(cy + bh / 2, 0, h)], -1)
    rois[rng.uniform(size=(B, R)) < 0.1] = 0.0
    return rois.astype(np.float32)


def _edge_rois():
    """(1, R, 4): sqrt(area) exactly on the level boundaries 112, 224 and
    448 (and 56, 896, clipped), zero-area padding, boxes partly and wholly
    outside the image, sub-pixel boxes, boxes on the last row and column of
    every level (the padded input is 800x1344)."""
    H, W = 800, 1344
    rows = [[0, 0, 0, 0], [300, 200, 300, 200], [-40, -60, 100, 90], [1200, 700, 1500, 900],
            [-300, -300, -10, -20], [2000, 900, 2100, 1000], [10.2, 20.7, 10.6, 21.0],
            [3.0, 3.0, 3.25, 3.5], [W - 3, H - 2, W, H], [0, H - 1, W, H], [W - 1, 0, W, H],
            [0, 0, W, H], [W - 40, H - 40, W + 20, H + 20]]
    for side in (56, 112, 224, 448, 896):
        for x, y in ((0, 0), (17, 33), (W - side, H - side)):
            for r in (0.25, 1.0, 4.0):
                rows.append([x, y, x + side * r ** 0.5, y + side / r ** 0.5])
    return np.float32(rows)[None]


def bf16_edge_rois():
    """The bf16 kernels' own edge cases on the 800x1344 canvas, {name: (B,
    R, 4) f32}: "large windows", boxes whose window takes more than the
    forward's staging room for its 16 channels (the whole image on P5, tall
    and wide thin boxes on P2: staged a group of channels at a time);
    "unaligned rows", 300x280 boxes on P4 and 600x560 ones on P5 whose
    windows start at 12 different columns each, odd ones among them (rows of
    168 and 84 bytes, not 16-byte aligned); "two level mixes", B = 2, image
    0's boxes 20-200 px (P2-P3), image 1's 230-900 px (P4-P5)."""
    H, W = 800, 1344
    large = [[0, 0, W, H], [0, 0, W, H - 40], [0, 0, 900, H], [100, 0, 112, H], [0, 390, W, 399],
             [600, 0, 640, H], [20, 30, 900, 700]]
    unaligned = ([[13.7 * k + 5, 40 + 9 * k, 13.7 * k + 305, 320 + 9 * k] for k in range(12)] +
                 [[27.3 * k + 3, 20 + 5 * k, 27.3 * k + 603, 580 + 5 * k] for k in range(12)])
    rng = np.random.RandomState(SEED + 7)
    mix = []
    for lo, hi in ((20, 200), (230, 900)):
        side = np.exp(rng.uniform(np.log(lo), np.log(hi), 40))
        x, y = rng.uniform(0, W - side), rng.uniform(0, H - np.minimum(side, H - 1))
        mix.append(np.stack([x, y, x + side, np.minimum(y + side, H)], -1))
    return {"large windows": np.float32(large)[None], "unaligned rows": np.float32(unaligned)[None],
            "two level mixes": np.float32(mix)}


def _roi_feats(gen, B, C=ROI_C):
    return [torch.randn(B, C, h, w, device="cuda", generator=gen) for h, w in ROI_LEVELS]


def roi_align_touched(feats, rois, levels, output_size=(7, 7)):
    """The (level, b, y, x) feature rows that some RoI's taps read with a
    nonzero weight, counted from the plain version's per-axis weights: a RoI
    reads the product of the rows and the columns its samples touch."""
    from basedet_tpu_torch.ops.roi_align import _axis_weights

    ph, pw = output_size
    touched = 0
    for li, (f, stride) in enumerate(zip(feats, ROI_STRIDES)):
        H, W = f.shape[-2:]
        box = rois / stride - 0.5
        mask = (levels == li).float()
        py = _axis_weights(box[..., 1], (box[..., 3] - box[..., 1]) / ph, ph, 2, H, mask)
        px = _axis_weights(box[..., 0], (box[..., 2] - box[..., 0]) / pw, pw, 2, W, mask)
        rows, cols = (py != 0).any(-2).float(), (px != 0).any(-2).float()  # (B, R, H), (B, R, W)
        touched += int((torch.einsum("bry,brx->byx", rows, cols) > 0).sum())
    return touched


def roi_align_bound(feats, rois, levels):
    """RoIAlign's bound: the output written once, the rois and level ids
    read once, and the C channels of every feature row that some RoI's taps
    touch read once (``roi_align_touched``), each element in the features'
    dtype; 16 taps x (2 multiplies + 1 add) + 4 sample weights per output
    element in f32."""
    B, R = levels.shape
    size = feats[0].element_size()
    out_elems = B * R * 7 * 7 * ROI_C
    feat_bytes = roi_align_touched(feats, rois, levels) * ROI_C * size
    t = bound(out_elems * size + feat_bytes + B * R * 20, out_elems * (16 * 3 + 4 * 4))
    return (*t, feat_bytes)


def _check_roi_align(name, feats, rois):
    from basedet_tpu_torch.ops.roi_align import multilevel_roi_align_plain, roi_level_assignment
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align

    levels = roi_level_assignment(rois, 2, 5)
    got = multilevel_roi_align(feats, rois, levels, ROI_STRIDES)
    torch.cuda.synchronize()
    want = multilevel_roi_align_plain(feats, rois, levels, ROI_STRIDES)
    err = float((got - want).abs().max())
    tol = 1e-5 * max(1.0, max(float(f.abs().max()) for f in feats))
    per_level = torch.bincount(levels.flatten().long(), minlength=4).tolist()
    log(f"[roi] {name:16s} B={rois.shape[0]} R={rois.shape[1]} C={feats[0].shape[1]}, RoIs per level "
        f"P2-P5 {per_level}: max |kernel - plain| {err:.3e} (tol {tol:.3e})")
    check(err <= tol, f"RoIAlign kernel differs from its plain version by {err} on case {name!r}")
    return err


def phase_roi_align(card):
    rng, gen = np.random.RandomState(SEED), torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    for B in (1, 2):
        feats = _roi_feats(gen, B)
        rois = torch.from_numpy(_proposal_rois(rng, B, ROI_R)).cuda()
        worst = max(worst, _check_roi_align("slice", feats, rois))
    worst = max(worst, _check_roi_align("edges", _roi_feats(gen, 1), torch.from_numpy(_edge_rois()).cuda()))
    big = [f * 1000.0 for f in _roi_feats(gen, 1)]  # the tolerance scales with max |F|
    worst = max(worst, _check_roi_align("edges |F|~4e3", big, torch.from_numpy(_edge_rois()).cuda()))
    for C in (100, 6):  # channels off the kernel's slab, and not a multiple of 4
        worst = max(worst, _check_roi_align(f"edges C={C}", _roi_feats(gen, 1, C), torch.from_numpy(_edge_rois()).cuda()))
    feats = [f.contiguous(memory_format=torch.channels_last) for f in _roi_feats(gen, 1)]
    worst = max(worst, _check_roi_align("channels-last F", feats, torch.from_numpy(_proposal_rois(rng, 1, 300)).cuda()))

    t = roi_align_timing(rng, gen, card)
    check(t["other_ops"] == 0, f"the RoIAlign wrapper ran device work besides its kernel: {t['names']}")
    return dict(max_abs_err=worst, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=None)


def roi_align_timing(rng, gen, card):
    """The RoIAlign wrapper at Faster R-CNN's eval shape (B = 1, R = 1000,
    C = 256, P2-P5 of 800x1344) on proposal-like RoIs: events time of the
    call, the device time of its kernel and of anything else it runs
    (profiler), the plain version and the bound."""
    from basedet_tpu_torch.ops.roi_align import multilevel_roi_align_plain, roi_level_assignment
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align

    feats = _roi_feats(gen, 1)
    rois = torch.from_numpy(_proposal_rois(rng, 1, ROI_R)).cuda()
    levels = roi_level_assignment(rois, 2, 5)
    call = lambda: multilevel_roi_align(feats, rois, levels, ROI_STRIDES)
    ms = cuda_ms(call, reps=50, warmup=5)
    device, ops, names = device_kernels(call, 10)
    kernel = sum(v for n, v in names.items() if "roi_align" in n)
    other = {n: v for n, v in names.items() if "roi_align" not in n}
    plain_ms = cuda_ms(lambda: multilevel_roi_align_plain(feats, rois, levels, ROI_STRIDES), reps=3, warmup=1)
    bound_ms, bound_by, feat_bytes = roi_align_bound(feats, rois, levels)
    log(f"[roi] B=1 R={ROI_R} C={ROI_C} levels {ROI_LEVELS}: wrapper {ms:.4f} ms per call; device time "
        f"(profiler) {device:.4f} ms in {ops:.0f} operations: the RoIAlign kernel {kernel:.4f} ms, anything else "
        f"{sum(other.values()):.4f} ms {sorted(other)}; plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {feat_bytes / 1e6:.1f} MB of the {sum(f.numel() * 4 for f in feats) / 1e6:.1f} MB of "
        f"P2-P5 touched) | {card}")
    return dict(ms=ms, device_ms=device, kernel_ms=kernel, other_ms=sum(other.values()),
                other_ops=len(other), names=sorted(names), plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def roi_align_bwd_bound(grad, sizes):
    """The RoIAlign backward's bound: g, the rois and the level ids read
    once, every level's dF written once, each element in g's dtype; per
    element of g, 4 samples' weights (4 multiplies) and 16 taps x (1 multiply
    + 1 add) in f32."""
    B, R = grad.shape[:2]
    size = grad.element_size()
    d_bytes = sum(B * h * w * grad.shape[-1] * size for h, w in sizes)
    t = bound(grad.numel() * size + d_bytes + B * R * 20, grad.numel() * (16 * 2 + 4))
    return (*t, d_bytes)


def _check_roi_align_bwd(name, grad, rois):
    from basedet_tpu_torch.ops.roi_align import multilevel_roi_align_backward_plain, roi_level_assignment
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align_backward

    levels = roi_level_assignment(rois, 2, 5)
    got = multilevel_roi_align_backward(grad, rois, levels, ROI_STRIDES, ROI_LEVELS)
    torch.cuda.synchronize()
    want = multilevel_roi_align_backward_plain(grad, rois, levels, ROI_STRIDES, ROI_LEVELS)
    again = multilevel_roi_align_backward(grad, rois, levels, ROI_STRIDES, ROI_LEVELS)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    biggest = max(float(w.abs().max()) for w in want)
    tol = ROI_BWD_RTOL * max(1.0, biggest)
    per_level = torch.bincount(levels.flatten().long(), minlength=4).tolist()
    equal = all(torch.equal(g, a) for g, a in zip(got, again))
    log(f"[roi-bwd] {name:16s} B={rois.shape[0]} R={rois.shape[1]} C={grad.shape[-1]}, RoIs per level "
        f"P2-P5 {per_level}: max |kernel - plain| {err:.3e} (tol {tol:.3e}, max |dF| {biggest:.3e}); "
        f"two runs of the kernel bit-equal: {equal}")
    check(all(g.shape == w.shape for g, w in zip(got, want)), "RoIAlign backward: wrong dF shapes")
    check(all(g.is_contiguous() for g in got), f"RoIAlign backward: a dF is not NCHW-contiguous on case {name!r}")
    check(equal, f"RoIAlign backward: two runs differ on case {name!r}")
    check(err <= tol, f"RoIAlign backward kernel differs from its plain version by {err} on case {name!r}")
    return err


def roi_align_bwd_cases(seed=SEED + 2):
    """Phase 4c's RoI sets at Faster R-CNN's train shape (B = 2, R = 512) and
    their g: {name: (g, rois)}, on the card."""
    rng, gen = np.random.RandomState(seed), torch.Generator(device="cuda").manual_seed(seed)
    B, R = FRCNN_TRAIN_B, FRCNN_TRAIN_R

    def grad_like(rois):
        return torch.randn(*rois.shape[:2], 7, 7, ROI_C, device="cuda", generator=gen)

    spread_rois = torch.from_numpy(_proposal_rois(rng, B, R)).cuda()
    same_rois = torch.from_numpy(np.broadcast_to(np.float32([301.3, 211.7, 642.9, 505.1]), (B, R, 4)).copy()).cuda()
    edge_rois = torch.from_numpy(_edge_rois()).cuda()
    cases = {name: (grad_like(rois), rois) for name, rois in (
        ("proposal-like", spread_rois), ("edges", edge_rois), ("identical RoIs", same_rois))}
    cases["edges |g|~1e3"] = (grad_like(edge_rois) * 1000.0, edge_rois)
    return cases


def roi_align_bwd_timing(grad, rois, card, name, plain=True):
    """The RoIAlign backward's wrapper on one g and its RoIs: events time per
    call, the device time of its kernel and of anything else it runs, device
    operations per call (profiler), the plain version and the bound."""
    from basedet_tpu_torch.ops.roi_align import multilevel_roi_align_backward_plain, roi_level_assignment
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align_backward

    levels = roi_level_assignment(rois, 2, 5)
    call = lambda: multilevel_roi_align_backward(grad, rois, levels, ROI_STRIDES, ROI_LEVELS)
    ms = cuda_ms(call, reps=30, warmup=5)
    device, ops, names = device_kernels(call, 10, names=("roi_align_bwd",))
    kernel = sum(v for n, v in names.items() if "roi_align_bwd" in n)
    other = {n: v for n, v in names.items() if "roi_align_bwd" not in n}
    plain_ms = (cuda_ms(lambda: multilevel_roi_align_backward_plain(grad, rois, levels, ROI_STRIDES, ROI_LEVELS),
                        reps=3, warmup=1) if plain else None)
    bound_ms, bound_by, d_bytes = roi_align_bwd_bound(grad, ROI_LEVELS)
    per_level = torch.bincount(levels.flatten().long(), minlength=4).tolist()
    log(f"[roi-bwd] {name}, B={grad.shape[0]} R={grad.shape[1]} C={grad.shape[-1]}, RoIs per level P2-P5 "
        f"{per_level}: wrapper {ms:.4f} ms per call (events); device time {device:.4f} ms in {ops:.2f} operations "
        f"a call (profiler): the kernel {kernel:.4f} ms, anything else {sum(other.values()):.4f} ms {sorted(other)}; "
        + (f"plain {plain_ms:.3f} ms; " if plain else "")
        + f"bound {bound_ms:.4f} ms ({bound_by}: {grad.numel() * grad.element_size() / 1e6:.1f} MB of g read, "
        f"{d_bytes / 1e6:.1f} MB "
        f"of dF written), the kernel at {bound_ms / kernel:.3f} of it | {card}")
    return dict(ms=ms, device_ms=device, kernel_ms=kernel, other_ms=sum(other.values()), ops=ops,
                names=sorted(names), plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_roi_align_bwd(card):
    cases = roi_align_bwd_cases()
    worst = max(_check_roi_align_bwd(name, grad, rois) for name, (grad, rois) in cases.items())
    times = {name: roi_align_bwd_timing(*cases[name], card, name) for name in ("proposal-like", "identical RoIs")}
    t = times["proposal-like"]
    check(t["ops"] == 1, f"the RoIAlign backward wrapper ran {t['ops']} device operations a call, not 1: {t['names']}")
    return dict(max_abs_err=worst, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=None)


# -- the bf16 RoIAlign kernels (#5-#8 in the JAX package's own dtype) -----------------------------

def _bf16_gate(got, want, f32_tol):
    """(worst |kernel - plain| in bf16 ulps of the larger of the two, elements past one ulp, elements
    past one ulp but within ``f32_tol``, the verdict). Both round once to bf16 from f32 sums that
    differ in order only, so an element may differ by one rounding step; where the value is so near 0
    that the f32 sums' order alone (the f32 kernel's own gate, ``f32_tol``) moves it by more than a bf16
    ulp, that gate holds it instead."""
    diff = (got.float() - want.float()).abs()
    ulp = torch.maximum(_bf16_ulp(got), _bf16_ulp(want))
    past = diff > ulp
    floored = past & (diff <= f32_tol)
    ok = not bool((past & (diff > f32_tol)).any())
    return float((diff / ulp).max()), int(past.sum()), int(floored.sum()), ok


def _check_roi_align_bf16(name, feats, rois):
    """The bf16 forward kernel against its plain version on bf16 features: the output's dtype, the
    gate of ``_bf16_gate`` (the f32 forward's 1e-5 of max(1, max|F|) as the floor); returns the
    largest |kernel - plain|."""
    from basedet_tpu_torch.ops.roi_align import multilevel_roi_align_plain, roi_level_assignment
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align

    feats = [f.bfloat16() for f in feats]
    levels = roi_level_assignment(rois, 2, 5)
    before = multilevel_roi_align.launches_bf16
    got = multilevel_roi_align(feats, rois, levels, ROI_STRIDES)
    torch.cuda.synchronize()
    check(multilevel_roi_align.launches_bf16 == before + 1 and got.dtype == torch.bfloat16,
          f"bf16 RoIAlign on case {name!r}: {got.dtype}, {multilevel_roi_align.launches_bf16 - before} bf16 launches")
    want = multilevel_roi_align_plain(feats, rois, levels, ROI_STRIDES)
    tol = 1e-5 * max(1.0, max(float(f.float().abs().max()) for f in feats))
    ulps, past, floored, ok = _bf16_gate(got, want, tol)
    err = float((got.float() - want.float()).abs().max())
    log(f"[roi-bf16] {name:16s} B={rois.shape[0]} R={rois.shape[1]} C={feats[0].shape[1]}: max |kernel - plain| "
        f"{err:.3e} = {ulps:.2f} bf16 ulps; {past} of {got.numel()} elements past one ulp, all {floored} of them "
        f"within the f32 gate {tol:.3e}: {ok}")
    check(ok, f"the bf16 RoIAlign kernel differs from its plain version by more than a bf16 ulp on case {name!r}")
    return err


def _check_roi_align_bwd_bf16(name, grad, rois):
    """The bf16 backward kernel against its plain version on a bf16 g: dF in bf16, NCHW-contiguous,
    two runs bit-equal, the gate of ``_bf16_gate`` (the f32 backward's ROI_BWD_RTOL of max(1, max|dF|)
    as the floor); returns the largest |kernel - plain|."""
    from basedet_tpu_torch.ops.roi_align import multilevel_roi_align_backward_plain, roi_level_assignment
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align_backward

    grad = grad.bfloat16()
    levels = roi_level_assignment(rois, 2, 5)
    before = multilevel_roi_align_backward.launches_bf16
    got = multilevel_roi_align_backward(grad, rois, levels, ROI_STRIDES, ROI_LEVELS)
    again = multilevel_roi_align_backward(grad, rois, levels, ROI_STRIDES, ROI_LEVELS)
    torch.cuda.synchronize()
    check(multilevel_roi_align_backward.launches_bf16 == before + 2 and all(g.dtype == torch.bfloat16 for g in got),
          f"bf16 RoIAlign backward on case {name!r}: {[g.dtype for g in got]}")
    want = multilevel_roi_align_backward_plain(grad, rois, levels, ROI_STRIDES, ROI_LEVELS)
    biggest = max(float(w.float().abs().max()) for w in want)
    tol = ROI_BWD_RTOL * max(1.0, biggest)
    gates = [_bf16_gate(g, w, tol) for g, w in zip(got, want)]
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    equal = all(torch.equal(g, a) for g, a in zip(got, again))
    log(f"[roi-bwd-bf16] {name:16s} B={rois.shape[0]} R={rois.shape[1]} C={grad.shape[-1]}: max |kernel - plain| "
        f"{err:.3e} = {max(g[0] for g in gates):.2f} bf16 ulps (max |dF| {biggest:.3e}); {sum(g[1] for g in gates)} "
        f"elements past one ulp, all {sum(g[2] for g in gates)} of them within the f32 gate {tol:.3e}: "
        f"{all(g[3] for g in gates)}; two runs bit-equal: {equal}")
    check(all(g.is_contiguous() and g.shape == w.shape for g, w in zip(got, want)),
          f"bf16 RoIAlign backward: a dF is not NCHW-contiguous (B, C, H, W) on case {name!r}")
    check(equal, f"bf16 RoIAlign backward: two runs differ on case {name!r}")
    check(all(g[3] for g in gates), f"the bf16 RoIAlign backward differs from its plain version by more than a bf16 "
                                    f"ulp on case {name!r}")
    return err


def roi_align_bf16_timing(feats, rois, card, name):
    """The forward wrapper on bf16 and on f32 features, the same RoIs: the kernels' device time
    (profiler), events, the bf16 plain version and each dtype's bound."""
    from basedet_tpu_torch.ops.roi_align import multilevel_roi_align_plain, roi_level_assignment
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align

    levels = roi_level_assignment(rois, 2, 5)
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        f = [x.to(dt) for x in feats]
        call = lambda: multilevel_roi_align(f, rois, levels, ROI_STRIDES)
        ms = cuda_ms(call, reps=20, warmup=3)
        _, _, names = device_kernels(call, 10, names=("roi_align",))
        kernel = sum(v for n, v in names.items() if "roi_align" in n)
        out[dt] = (ms, kernel, *roi_align_bound(f, rois, levels)[:2])
    bf = [x.bfloat16() for x in feats]
    plain_ms = cuda_ms(lambda: multilevel_roi_align_plain(bf, rois, levels, ROI_STRIDES), reps=3, warmup=1)
    (ms, kernel, b_ms, b_by), (ms32, kernel32, b32, _) = out[torch.bfloat16], out[torch.float32]
    log(f"[roi-bf16] forward {name}, B={rois.shape[0]} R={rois.shape[1]} C={feats[0].shape[1]}: bf16 kernel device "
        f"{kernel:.4f} ms (profiler), events {ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}), the kernel at "
        f"{b_ms / kernel:.3f} of it; the f32 kernel on the same RoIs {kernel32:.4f} ms device, {ms32:.4f} events "
        f"(bound {b32:.4f}, the kernel at {b32 / kernel32:.3f} of it); bf16 / f32 device time {kernel / kernel32:.3f}; "
        f"bf16 plain {plain_ms:.3f} ms | {card}")
    return dict(ms=kernel, events_ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, f32_ms=kernel32)


def roi_align_bwd_bf16_timing(grad, rois, card, name):
    """The backward wrapper on a bf16 g and on the f32 g, the same RoIs: device time (profiler),
    events, the bf16 plain version and each dtype's bound."""
    from basedet_tpu_torch.ops.roi_align import multilevel_roi_align_backward_plain, roi_level_assignment
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align_backward

    levels = roi_level_assignment(rois, 2, 5)
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        g = grad.to(dt)
        call = lambda: multilevel_roi_align_backward(g, rois, levels, ROI_STRIDES, ROI_LEVELS)
        ms = cuda_ms(call, reps=20, warmup=3)
        _, ops, names = device_kernels(call, 10, names=("roi_align_bwd",))
        kernel = sum(v for n, v in names.items() if "roi_align_bwd" in n)
        out[dt] = (ms, kernel, ops, *roi_align_bwd_bound(g, ROI_LEVELS)[:2])
    g16 = grad.bfloat16()
    plain_ms = cuda_ms(lambda: multilevel_roi_align_backward_plain(g16, rois, levels, ROI_STRIDES, ROI_LEVELS),
                       reps=3, warmup=1)
    (ms, kernel, ops, b_ms, b_by), (ms32, kernel32, _, b32, _) = out[torch.bfloat16], out[torch.float32]
    check(ops == 1, f"the bf16 RoIAlign backward ran {ops} device operations a call, not 1")
    log(f"[roi-bwd-bf16] {name}, B={grad.shape[0]} R={grad.shape[1]} C={grad.shape[-1]}: bf16 kernel device "
        f"{kernel:.4f} ms (profiler, {ops} operation a call), events {ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}), the "
        f"kernel at {b_ms / kernel:.3f} of it; the f32 kernel on the same RoIs {kernel32:.4f} ms device, {ms32:.4f} "
        f"events (bound {b32:.4f}, the kernel at {b32 / kernel32:.3f} of it); bf16 / f32 device time "
        f"{kernel / kernel32:.3f}; bf16 plain {plain_ms:.3f} ms | {card}")
    return dict(ms=kernel, events_ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, f32_ms=kernel32)


def phase_roi_align_bf16(card):
    """4d. The bf16 RoIAlign forward and backward against their plain versions on phase 4b's and
    4c's cases (proposal-like at B = 1 and 2, edges, |F| and |g| ~ 1e3, C = 100 and 6,
    channels-last features, identical RoIs) and on ``bf16_edge_rois`` (large windows and rows off
    16 bytes at C = 256, 100 and 6, channels-last features, two level mixes), then timed beside the
    f32 kernels at the eval shape (B = 1, R = 1000), the train shape (B = 2, R = 512) and on
    identical RoIs. Returns the report entries."""
    rng, gen = np.random.RandomState(SEED + 4), torch.Generator(device="cuda").manual_seed(SEED + 4)
    edges = torch.from_numpy(_edge_rois()).cuda()
    worst = 0.0
    for B, R in ((1, ROI_R), (FRCNN_TRAIN_B, FRCNN_TRAIN_R)):
        worst = max(worst, _check_roi_align_bf16(f"proposal-like", _roi_feats(gen, B),
                                                 torch.from_numpy(_proposal_rois(rng, B, R)).cuda()))
    worst = max(worst, _check_roi_align_bf16("edges", _roi_feats(gen, 1), edges))
    worst = max(worst, _check_roi_align_bf16("edges |F|~4e3", [f * 1000.0 for f in _roi_feats(gen, 1)], edges))
    for C in (100, 6):
        worst = max(worst, _check_roi_align_bf16(f"edges C={C}", _roi_feats(gen, 1, C), edges))
    same = torch.from_numpy(np.broadcast_to(np.float32([301.3, 211.7, 642.9, 505.1]),
                                            (FRCNN_TRAIN_B, FRCNN_TRAIN_R, 4)).copy()).cuda()
    worst = max(worst, _check_roi_align_bf16("identical RoIs", _roi_feats(gen, FRCNN_TRAIN_B), same))
    feats = [f.contiguous(memory_format=torch.channels_last) for f in _roi_feats(gen, 1)]
    worst = max(worst, _check_roi_align_bf16("channels-last F", feats, torch.from_numpy(_proposal_rois(rng, 1, 300)).cuda()))
    cases = roi_align_bwd_cases(SEED + 5)
    worst_bwd = max(_check_roi_align_bwd_bf16(name, g, rois) for name, (g, rois) in cases.items())
    for C in (100, 6):  # channels off the block's slab: the narrower copies of g
        g = torch.randn(1, edges.shape[1], 7, 7, C, device="cuda", generator=gen)
        worst_bwd = max(worst_bwd, _check_roi_align_bwd_bf16(f"edges C={C}", g, edges))
    for name, boxes in bf16_edge_rois().items():
        rois = torch.from_numpy(boxes).cuda()
        B = rois.shape[0]
        for C in ((ROI_C, 100, 6) if name != "two level mixes" else (ROI_C,)):
            tag = name if C == ROI_C else f"{name} C={C}"
            worst = max(worst, _check_roi_align_bf16(tag, _roi_feats(gen, B, C), rois))
            g = torch.randn(B, rois.shape[1], 7, 7, C, device="cuda", generator=gen)
            worst_bwd = max(worst_bwd, _check_roi_align_bwd_bf16(tag, g, rois))
        if name == "unaligned rows":
            feats = [f.contiguous(memory_format=torch.channels_last) for f in _roi_feats(gen, B)]
            worst = max(worst, _check_roi_align_bf16(f"{name}, channels-last F", feats, rois))
    fwd = roi_align_bf16_timing(_roi_feats(gen, 1), torch.from_numpy(_proposal_rois(rng, 1, ROI_R)).cuda(), card,
                                "eval shape")
    fwd_train = roi_align_bf16_timing(_roi_feats(gen, FRCNN_TRAIN_B), cases["proposal-like"][1], card, "train shape")
    roi_align_bf16_timing(_roi_feats(gen, FRCNN_TRAIN_B), cases["identical RoIs"][1], card, "identical RoIs")
    bwd = roi_align_bwd_bf16_timing(*cases["proposal-like"], card, "proposal-like")
    roi_align_bwd_bf16_timing(*cases["identical RoIs"], card, "identical RoIs")
    keys = ("plain_ms", "bound_ms", "bound_by")
    return ({"max_abs_err": worst, "ms": fwd["events_ms"], **{k: fwd[k] for k in keys}, "library_ms": None},
            {"max_abs_err": worst_bwd, "ms": bwd["events_ms"], **{k: bwd[k] for k in keys}, "library_ms": None})


@torch.no_grad()
def randomise_frcnn(module, generator):
    """Draw the frozen BN statistics and affine and every conv and fc bias
    from generator, as ``randomise`` does for YOLOX-S; raise the RPN's
    box-size biases by log 3, so that a proposal spans about three times its
    anchor's side and the proposals reach every pooling level P2-P5 (with
    the plain init all 1000 land on P2, the top-scoring anchors being the
    small ones); and spread the class logits' biases by 2, so that some
    classes clear the 0.05 score threshold of an untrained head (whose
    softmax over 81 classes gives ~0.012)."""
    from basedet_tpu_torch.layers.common.blocks import FrozenBatchNorm

    for m in module.modules():
        if isinstance(m, FrozenBatchNorm):
            m.running_mean.normal_(0.0, 0.2, generator=generator)
            m.running_var.uniform_(0.5, 2.0, generator=generator)
            m.weight.uniform_(0.5, 1.5, generator=generator)
        if getattr(m, "bias", None) is not None:
            m.bias.add_(torch.empty_like(m.bias).normal_(0.0, 0.3, generator=generator))
    module.rpn.rpn_bbox_offsets.bias.view(-1, 4)[:, 2:].add_(math.log(3.0))  # (dx, dy, dw, dh) per anchor
    bias = module.rcnn.pred_cls.bias
    bias.add_(torch.empty_like(bias).normal_(0.0, 2.0, generator=generator))


def make_frcnn_weights(out_dir):
    """Full-width Faster R-CNN R50-FPN on the card with random weights from
    SEED, spread by ``randomise_frcnn``, saved as a state_dict."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.tools import import_config

    cfg = import_config(FRCNN_CONFIG)
    cfg.merge(_frcnn_opts(out_dir))
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    model = build_model(cfg, "cuda", generator)
    randomise_frcnn(model.module, generator)
    weights = os.path.join(out_dir, "faster_rcnn_r50_seed0.pt")
    torch.save(model.module.state_dict(), weights)
    n_params = sum(p.numel() for p in model.module.parameters())
    log(f"[frcnn] {FRCNN_CONFIG}: {cfg.MODEL.BACKBONE.NAME} (FrozenBN, freeze_at "
        f"{cfg.MODEL.BACKBONE.FREEZE_AT}), FPN {cfg.MODEL.FPN.OUT_CHANNELS}, RPN top "
        f"{cfg.MODEL.RPN.TEST_PREV_NMS_TOPK}/{cfg.MODEL.RPN.TEST_POST_NMS_TOPK}, "
        f"{cfg.DATA.NUM_CLASSES} classes, {n_params} parameters, random from seed {SEED}")
    return cfg, model, weights


def _frcnn_opts(out_dir):
    return ["DATA.TEST.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", str(FRCNN_IMAGE).replace(" ", ""),
            "GLOBAL.OUTPUT_DIR", out_dir]


def _frcnn_train_opts(out_dir, weights):
    return ["DATA.TRAIN.name", "dummy", "DATA.TEST.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", str(FRCNN_IMAGE).replace(" ", ""),
            "MODEL.BATCHSIZE", str(FRCNN_TRAIN_B), "SOLVER.MAX_EPOCH", "1",
            "SOLVER.NUM_IMAGE_PER_EPOCH", str(4 * FRCNN_TRAIN_B), "GLOBAL.LOG_INTERVAL", "1",
            "MODEL.WEIGHTS", weights, "GLOBAL.OUTPUT_DIR", out_dir,
            "GLOBAL.CKPT_SAVE_DIR", os.path.join(out_dir, "frcnn_ckpt")]


def phase_frcnn_train(out_dir, weights):
    """det_train on full-width Faster R-CNN, 4 steps of 2 images of 800x1333;
    the RoIAlign (forward and backward), NMS and IoU counts are zeroed just
    before and read just after (the IoU twice a step: RPN targets and R-CNN
    sampling). Returns the launches, the dumped weights and the first step's
    two IoU calls' arguments."""
    from basedet_tpu_torch.layers.head import rcnn
    from basedet_tpu_torch.models.det import rpn
    from basedet_tpu_torch.models.det.faster_rcnn import FasterRCNN, FasterRCNNModule
    from basedet_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain
    from basedet_tpu_torch.ops.roi_align import (multilevel_roi_align_backward_plain,
                                                 multilevel_roi_align_plain, roi_level_assignment)
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align, multilevel_roi_align_backward
    from basedet_tpu_torch.tools import det_train

    def sampled(args, out):  # per step: foreground, background, sampled RoIs per level P2-P5
        rois, labels, _, weights = out
        levels = roi_level_assignment(rois, 2, 5)
        return (int((labels > 0).sum()), int((labels == 0).sum()),
                torch.bincount(levels[weights > 0].long(), minlength=4).tolist())

    keep_losses = lambda args, out: {k: float(v.detach()) for k, v in out[1].items()}
    kernels = (multilevel_roi_align, multilevel_roi_align_backward, nms_keep)
    plains = (multilevel_roi_align_plain, multilevel_roi_align_backward_plain, nms_keep_plain)
    keep_args = lambda args, out: tuple(a.clone() for a in args)
    with recording(FasterRCNNModule, "sample", sampled) as samples, \
            recording(FasterRCNN, "get_losses", keep_losses) as losses, nms_counts() as seen, \
            recording(rpn, "box_iou", keep_args) as rpn_iou, recording(rcnn, "box_iou", keep_args) as rcnn_iou, \
            iou_counted("Faster R-CNN det_train"):
        for fn in kernels:
            fn.launches = 0
        for fn in plains:
            fn.calls = 0
        t0 = time.perf_counter()
        trainer = det_train.main(["-f", FRCNN_CONFIG, "--device", "cuda", *_frcnn_train_opts(out_dir, weights)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = [fn.launches for fn in kernels]
        plain_calls = [fn.calls for fn in plains]

    steps = trainer.state.step
    ckpt = os.path.join(out_dir, "frcnn_ckpt")
    per_level = np.sum([s[2] for s in samples], axis=0).tolist()
    check(steps == 4 and len(losses) == 4, f"Faster R-CNN det_train took {steps} steps, not 4")
    check(launches == [steps] * 3, f"RoIAlign forward, backward and NMS kernels launched {launches} "
                                   f"times in {steps} steps")
    check(plain_calls == [0, 0, 0], f"plain versions ran {plain_calls} times on the main path")
    iou = check_iou_counts("Faster R-CNN det_train", 2 * steps)
    check(len(rpn_iou) == len(rcnn_iou) == steps, f"{len(rpn_iou)} RPN and {len(rcnn_iou)} R-CNN IoU calls "
                                                   f"in {steps} steps")
    check(tuple(rpn_iou[0][0].shape) == (FRCNN_TRAIN_B, 100, 4) and tuple(rpn_iou[0][1].shape) == (FRCNN_ANCHORS, 4),
          f"the RPN's IoU took {[tuple(a.shape) for a in rpn_iou[0]]}, not the full-width shapes")
    check(all(math.isfinite(v) for step in losses for v in step.values()), f"non-finite losses {losses}")
    check(all(len(step) == 5 and step["total_loss"] > 0 for step in losses), f"losses {losses}")
    # the synthetic gt boxes reach P3 and P4 (sqrt(area) up to ~410 px) and an untrained RPN's best
    # 1000 of 8819 candidates are mostly P2's: mixed levels in each launch, not every level
    check(sum(n > 0 for n in per_level) >= 3, f"sampled RoIs per level P2-P5 {per_level}: fewer than 3 levels")
    check(all(fg > 0 and bg > 0 for fg, bg, _ in samples), f"a step sampled no foreground or background: {samples}")
    check(len(seen) == steps and all(len(call) == FRCNN_TRAIN_B for call in seen),
          f"NMS saw {[len(call) for call in seen]} images per call, not {FRCNN_TRAIN_B} in each of {steps}")
    for name in ("latest.pt", "epoch_1.pt", "dumped_model.pt"):
        check(os.path.exists(os.path.join(ckpt, name)), f"Faster R-CNN det_train wrote no {name}")
    per_step = "; ".join(", ".join(f"{k.replace('_loss', '')} {v:.4f}" for k, v in step.items())
                         for step in losses)
    log(f"[frcnn-train] det_train Faster R-CNN R50-FPN, 4 steps of {FRCNN_TRAIN_B} images "
        f"{FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} (padded 800x1344), f32, in {seconds:.2f} s; kernel launches: "
        f"RoIAlign forward {launches[0]}, RoIAlign backward {launches[1]}, NMS {launches[2]}; plain calls "
        f"{plain_calls}; {iou} (RPN targets at {tuple(rpn_iou[0][0].shape)} x {tuple(rpn_iou[0][1].shape)}, "
        f"R-CNN sampling at {tuple(rcnn_iou[0][0].shape)} x {tuple(rcnn_iou[0][1].shape)}); lr "
        f"{trainer.meters['lr'].latest:.4g} (step 3 of the 500-step warm-up); losses per step: {per_step}; "
        f"sampled per step (foreground, background of {FRCNN_TRAIN_B * FRCNN_TRAIN_R} "
        f"rows): {[s[:2] for s in samples]}; sampled RoIs per level P2-P5 over the 4 steps {per_level}; "
        f"RPN NMS kept per image {_kept_range(seen)}; checkpoints latest.pt, epoch_1.pt, dumped_model.pt written")
    return launches, os.path.join(ckpt, "dumped_model.pt"), {"rpn": rpn_iou[0], "rcnn": rcnn_iou[0]}


def phase_frcnn_slice(out_dir, weights):
    """det_test on full-width Faster R-CNN over 8 requests; the RoIAlign,
    NMS and IoU counts are zeroed just before and read just after (it reaches
    no IoU)."""
    from basedet_tpu_torch.models.det import faster_rcnn
    from basedet_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain
    from basedet_tpu_torch.ops.roi_align import multilevel_roi_align_plain, roi_level_assignment
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align
    from basedet_tpu_torch.tools import det_test

    def level_counts(args, out):  # RoIs with positive area (proposals, not padding) per level
        rois = args[1]
        area = (rois[..., 2] - rois[..., 0]) * (rois[..., 3] - rois[..., 1])
        levels = roi_level_assignment(rois, 2, 5)
        return torch.bincount(levels[area > 0].long(), minlength=4).tolist()

    multilevel_roi_align.launches, multilevel_roi_align_plain.calls = 0, 0
    nms_keep.launches, nms_keep_plain.calls = 0, 0
    t0 = time.perf_counter()
    with recording(faster_rcnn, "pool_rois_multilevel", level_counts) as levels, \
            nms_counts() as seen, iou_counted("Faster R-CNN det_test"):
        results = det_test.main(["-f", FRCNN_CONFIG, "-w", weights, "--device", "cuda",
                                 *_frcnn_opts(out_dir)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    roi_launches, roi_plain = multilevel_roi_align.launches, multilevel_roi_align_plain.calls
    nms_launches, nms_plain = nms_keep.launches, nms_keep_plain.calls

    with open(os.path.join(out_dir, "predict_coco.json")) as f:
        records = json.load(f)
    per_level = np.sum(levels, axis=0).tolist()
    check(len(records) >= 1, "Faster R-CNN det_test gave no detections")
    check(np.isfinite([r["bbox"] + [r["score"]] for r in records]).all(), "non-finite detections")
    check({r["image_id"] for r in records} == set(range(8)), "not every request was answered")
    check(roi_launches == 8, f"the RoIAlign kernel launched {roi_launches} times for 8 requests")
    check(roi_plain == 0, f"the plain RoIAlign ran {roi_plain} times on the main path")
    check(nms_launches == 16, f"the NMS kernel launched {nms_launches} times for 8 requests")
    check(nms_plain == 0, f"the plain NMS ran {nms_plain} times on the main path")
    check_iou_counts("Faster R-CNN det_test", 0)
    check(all(n > 0 for n in per_level), f"RoIs per level P2-P5 {per_level}: a level got none")
    rpn, final = seen[0::2], seen[1::2]
    log(f"[frcnn] det_test Faster R-CNN R50-FPN with {os.path.basename(weights)} on 8 requests of {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} "
        f"(padded 800x1344): {results}, {len(records)} finite detections in {seconds:.2f} s; "
        f"RoIAlign kernel launches {roi_launches}, plain calls {roi_plain}; NMS kernel launches "
        f"{nms_launches}, plain calls {nms_plain}; RPN NMS kept per image {_kept_range(rpn)}, final "
        f"NMS kept {_kept_range(final)}; proposals per level P2-P5 over the 8 requests {per_level}")
    return roi_launches, nms_launches


def _frcnn_stages(model, batch):
    """The RPN's proposals and valid flags and the detections of one batch,
    on the CPU."""
    from basedet_tpu_torch.layers.common.function import full_f32

    with torch.inference_mode(), full_f32():
        x = model.pre_process(batch)
        feats = model.module.features(x["image"])
        proposals, valid = model.module.proposals(feats, x["img_info"])
    dets = {k: v.cpu() for k, v in model.inference(batch).items()}
    return proposals.cpu(), valid.cpu(), dets


def _slot_agreement(cpu_boxes, cpu_valid, gpu_boxes, gpu_valid, extra=None):
    """Fraction of the CPU's valid slots whose card slot is valid with every
    coordinate within FRCNN_ATOL (and ``extra`` true), and the largest
    coordinate difference over those matched slots."""
    close = (gpu_boxes - cpu_boxes).abs().amax(-1)
    ok = cpu_valid & gpu_valid & (close <= FRCNN_ATOL)
    if extra is not None:
        ok &= extra
    frac = float(ok.sum()) / max(int(cpu_valid.sum()), 1)
    return frac, float(close[ok].max()) if ok.any() else 0.0


def phase_frcnn_card_vs_cpu(cfg, model, weights):
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.data import build_test_dataloader

    cpu = build_model(cfg, "cpu")
    cpu.load_weights(weights)
    batch = next(iter(build_test_dataloader(cfg)))  # det_test's first request
    batch = {k: batch[k] for k in ("data", "im_info")}
    t0 = time.perf_counter()
    c_prop, c_valid, c_dets = _frcnn_stages(cpu, batch)
    cpu_s = time.perf_counter() - t0
    g_prop, g_valid, g_dets = _frcnn_stages(model, batch)
    prop_frac, prop_err = _slot_agreement(c_prop, c_valid, g_prop, g_valid)
    same = ((g_dets["box_labels"] == c_dets["box_labels"])
            & ((g_dets["box_scores"] - c_dets["box_scores"]).abs() <= FRCNN_ATOL))
    det_frac, det_err = _slot_agreement(c_dets["boxes"], c_dets["valid"], g_dets["boxes"],
                                        g_dets["valid"], same)
    score_err = float((g_dets["box_scores"] - c_dets["box_scores"])[same & c_dets["valid"]].abs().max())
    log(f"[parity] Faster R-CNN card vs CPU, f32, one {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} image (CPU "
        f"run {cpu_s:.1f} s, plain RoIAlign): proposals {int(c_valid.sum())} CPU / {int(g_valid.sum())} "
        f"card valid, {prop_frac:.4f} of slots matched, max |dbox| {prop_err:.3e} on them; detections "
        f"{int(c_dets['valid'].sum())} CPU / {int(g_dets['valid'].sum())} card, {det_frac:.4f} of "
        f"slots matched (label, |dbox|, |dscore| <= {FRCNN_ATOL}), max |dbox| {det_err:.3e}, max "
        f"|dscore| {score_err:.3e} on them")
    check(bool(g_dets["valid"].any()) and torch.isfinite(g_dets["boxes"]).all(),
          "card detections empty or non-finite")
    check(prop_frac >= FRCNN_AGREE, f"only {prop_frac:.3f} of the CPU's proposals matched on the card")
    check(det_frac >= FRCNN_AGREE, f"only {det_frac:.3f} of the CPU's detections matched on the card")


def _frcnn_train_setup(weights, device):
    """Full-width Faster R-CNN in train mode with ``weights``, its train
    state and step, and the first synthetic batch of 2 images of 800x1333."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.data import DataloaderBuilder
    from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
    from basedet_tpu_torch.solver import DetSolver
    from basedet_tpu_torch.tools import import_config

    cfg = import_config(FRCNN_CONFIG)
    cfg.merge(_frcnn_train_opts(".", weights))
    model = build_model(cfg, device)
    model.load_weights(weights)
    model.train()
    solver = DetSolver.build(cfg)
    state = TrainState(model, solver)
    return model, state, make_train_step(model, solver, cfg), next(DataloaderBuilder.build(cfg))


def _frcnn_train_stages(model, batch, noise, proposals=None):
    """One train forward and backward through the module's stage methods,
    with ``proposals`` (boxes, valid) from another run in place of its own
    when given. Returns the RPN labels, its own proposals, the sampled
    labels, the four losses and the total's gradient norm, on the CPU."""
    from basedet_tpu_torch.layers.common.function import full_f32

    m = model.module
    noise = {k: v.to(model.device) for k, v in noise.items()}
    with full_f32():
        x = model.pre_process(batch, train=True)
        num_gt = x["img_info"][:, 4].long()
        feats = m.features(x["image"])
        rpn_out = m.rpn_head(feats)
        labels, offsets = m.rpn_targets(feats, x["gt_boxes"], num_gt, noise["rpn_pos"], noise["rpn_neg"])
        rpn_cls, rpn_reg = m.rpn_loss(rpn_out, labels, offsets)
        own = m.proposals(feats, x["img_info"], train=True, rpn_out=rpn_out)
        boxes, valid = own if proposals is None else (t.to(model.device) for t in proposals)
        rois, roi_labels, targets, weights = m.sample(
            boxes, valid, x["gt_boxes"], num_gt, noise["rcnn_fg"], noise["rcnn_bg"], noise["rcnn_tie"])
        rcnn_cls, rcnn_reg = m.head_losses(m.pool(feats, rois), roi_labels, targets, weights)
        m.zero_grad(set_to_none=True)
        (rpn_cls + rpn_reg + rcnn_cls + rcnn_reg).backward()
    norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in m.parameters() if p.grad is not None)))
    losses = {k: float(v.detach()) for k, v in
              dict(rpn_cls=rpn_cls, rpn_reg=rpn_reg, rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg).items()}
    return dict(rpn_labels=labels.cpu(), proposals=tuple(t.cpu() for t in own), roi_labels=roi_labels.cpu(),
                losses=losses, grad_norm=norm)


def phase_frcnn_train_vs_cpu(weights):
    """One Faster R-CNN train step on the CPU and on the card: same weights,
    batch and noise (a CPU and a CUDA generator give different streams, so it
    is drawn once on the CPU and copied). The card's R-CNN stages run on the
    CPU run's proposals."""
    from basedet_tpu_torch.layers.common.sampling import draw_sampling_noise

    noise = draw_sampling_noise(42, 0, FRCNN_TRAIN_B, FRCNN_ANCHORS, FRCNN_CANDIDATES, "cpu")
    model, _, _, batch = _frcnn_train_setup(weights, "cpu")
    t0 = time.perf_counter()
    cpu = _frcnn_train_stages(model, batch, noise)
    cpu_s = time.perf_counter() - t0
    model = _frcnn_train_setup(weights, "cuda")[0]
    gpu = _frcnn_train_stages(model, batch, noise, proposals=cpu["proposals"])

    agree = float((gpu["rpn_labels"] == cpu["rpn_labels"]).float().mean())
    prop_frac, prop_err = _slot_agreement(*cpu["proposals"], *gpu["proposals"])
    same_rois = bool((gpu["roi_labels"] == cpu["roi_labels"]).all())
    rel = {k: abs(gpu["losses"][k] - v) / max(abs(v), 1e-12) for k, v in cpu["losses"].items()}
    norm_rel = abs(gpu["grad_norm"] - cpu["grad_norm"]) / cpu["grad_norm"]
    labels = cpu["rpn_labels"]
    log(f"[parity] Faster R-CNN train step card vs CPU, f32, batch {FRCNN_TRAIN_B} of "
        f"{FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} (CPU run {cpu_s:.1f} s, plain RoIAlign forward and backward), "
        f"same noise: RPN labels agree on {agree:.6f} of {labels.numel()} anchors (min {RPN_LABEL_AGREE}; CPU "
        f"{int((labels == 1).sum())} positives, {int((labels == 0).sum())} negatives sampled); the card's own "
        f"train proposals match {prop_frac:.4f} of the CPU's slots (max |dbox| {prop_err:.3e}); on the CPU's "
        f"proposals: sampled labels equal {same_rois} ({int((cpu['roi_labels'] > 0).sum())} foreground, "
        f"{int((cpu['roi_labels'] == 0).sum())} background); losses card "
        f"{', '.join(f'{k} {v:.6f}' for k, v in gpu['losses'].items())} / CPU "
        f"{', '.join(f'{k} {v:.6f}' for k, v in cpu['losses'].items())}, worst rel diff "
        f"{max(rel.values()):.3e} (tol {LOSS_RTOL}); gradient norm {gpu['grad_norm']:.6f} card / "
        f"{cpu['grad_norm']:.6f} CPU, rel diff {norm_rel:.3e} (tol {GRAD_NORM_RTOL})")
    check(all(math.isfinite(v) for v in gpu["losses"].values()), "non-finite Faster R-CNN losses on the card")
    check(agree >= RPN_LABEL_AGREE, f"only {agree:.6f} of the RPN labels agree between card and CPU")
    check(same_rois, "the sampled RoI labels differ between card and CPU on the same proposals and noise")
    check(max(rel.values()) <= LOSS_RTOL, f"Faster R-CNN train losses differ between card and CPU: {rel}")
    check(norm_rel <= GRAD_NORM_RTOL, f"Faster R-CNN gradient norms differ by {norm_rel:.3e}")


def frcnn_train_inputs(weights):
    """Full-width Faster R-CNN in train mode on the card, its train state and
    step, its first batch on the card and the sampling noise of step 0."""
    from basedet_tpu_torch.layers.common.sampling import draw_sampling_noise

    model, state, step, batch = _frcnn_train_setup(weights, "cuda")
    batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    noise = draw_sampling_noise(42, 0, FRCNN_TRAIN_B, FRCNN_ANCHORS, FRCNN_CANDIDATES, "cuda")
    return model, state, step, batch, noise


# dF of each pooled level at the train shape, as the profiler prints input shapes
DF_SHAPES = [[FRCNN_TRAIN_B, ROI_C, h, w] for h, w in ROI_LEVELS]
COPY_OPS = ("aten::copy_", "aten::clone", "aten::contiguous", "aten::_to_copy", "aten::add", "aten::add_")


def frcnn_backward_report(model, batch, noise, card):
    """What a Faster R-CNN train step's backward does with the RoIAlign
    backward's output (f32, batch 2 of 800x1333): the gradient that reaches
    the pooled features and its RoIs recorded from one backward, the
    RoIAlign backward timed alone on them (``roi_align_bwd_timing``); then
    one backward under torch.profiler: the copies and adds that take a
    dF-sized (B, 256, H_l, W_l) tensor, and the device kernels that run in
    NHWC (a name containing "nhwc": cuDNN's NHWC convolution gradients and
    its layout conversions), each with its count and device time."""
    from torch.profiler import ProfilerActivity

    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.models.det.faster_rcnn import FasterRCNNModule

    m = model.module
    grads = []
    with recording(FasterRCNNModule, "pool", lambda args, out: (out.register_hook(grads.append), args[2])[1]) as pooled_rois, \
            full_f32():
        m.zero_grad(set_to_none=True)
        model.get_losses(batch, noise=noise)[0].backward()
    g, rois = grads[-1].contiguous(), pooled_rois[-1]
    roi_bwd = roi_align_bwd_timing(g, rois, card, "the train step's own g", plain=False)
    nonzero = float((g != 0).float().mean())
    del grads, g

    for _ in range(3):
        m.zero_grad(set_to_none=True)
        with full_f32():
            loss = model.get_losses(batch, noise=noise)[0]
        torch.cuda.synchronize()
        with padded_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof, full_f32():
            loss.backward()
            torch.cuda.synchronize()
        averages = prof.key_averages(group_by_input_shape=True)
        key = "device_time_total" if len(averages) and hasattr(averages[0], "device_time_total") else "cuda_time_total"
        kernels = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    check(kernels, "the profiler saw no device kernel in the Faster R-CNN backward")
    ms = lambda e: getattr(e, key) / 1000
    busy = sum(ms(e) for e in kernels)
    nhwc = {}
    for e in kernels:
        if "nhwc" in e.key.lower():
            n, t = nhwc.get(e.key, (0, 0.0))
            nhwc[e.key] = (n + e.count, t + ms(e))
    copies = {}
    for e in averages:
        shapes = [list(sh) for sh in (e.input_shapes or [])]
        if e.key in COPY_OPS and any(sh in DF_SHAPES for sh in shapes):
            name = f"{e.key} {shapes}"
            n, t = copies.get(name, (0, 0.0))
            copies[name] = (n + e.count, t + ms(e))
    roi = sum(ms(e) for e in kernels if "roi_align_bwd" in e.key)
    log(f"[frcnn-bwd] one f32 backward, batch {FRCNN_TRAIN_B} of {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]}: device "
        f"{busy:.3f} ms in {sum(e.count for e in kernels)} kernels (profiler), the RoIAlign backward kernel {roi:.4f} ms; "
        f"NHWC kernels {sum(n for n, _ in nhwc.values())} ({sum(t for _, t in nhwc.values()):.3f} ms): "
        f"{ {k[:110]: (n, round(t, 4)) for k, (n, t) in sorted(nhwc.items())} }; copies and adds on a dF-sized "
        f"tensor {sum(n for n, _ in copies.values())} ({sum(t for _, t in copies.values()):.3f} ms): "
        f"{ {k: (n, round(t, 4)) for k, (n, t) in sorted(copies.items())} } | {card}")
    return dict(roi_bwd=roi_bwd, nonzero=nonzero, busy_ms=busy, roi_kernel_ms=roi, nhwc=nhwc, copies=copies)


def phase_frcnn_train_timing(weights, card):
    """One f32 Faster R-CNN train step at batch 2 of 800x1333 (input already
    on the card): the stage methods each timed alone on the previous stage's
    outputs, gradients enabled; get_losses, get_losses with backward and the
    whole step as nested prefixes; and ``frcnn_backward_report``: the
    RoIAlign backward alone on the arguments a real backward gave it, and
    what the backward around it does with dF."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align_backward

    model, state, step, batch, noise = frcnn_train_inputs(weights)
    m, reps = model.module, MODEL_REPS

    def timed(fn):
        def run():
            with full_f32():
                return fn()
        return cuda_ms(run, reps=reps, warmup=2), run()

    x = model.pre_process(batch, train=True)
    image, info, gt = x["image"], x["img_info"], x["gt_boxes"]
    num_gt = info[:, 4].long()
    t_feat, feats = timed(lambda: m.features(image))
    t_rpn, rpn_out = timed(lambda: m.rpn_head(feats))
    t_targets, _ = timed(lambda: m.rpn_loss(rpn_out, *m.rpn_targets(feats, gt, num_gt, noise["rpn_pos"],
                                                                       noise["rpn_neg"])))
    t_prop, (proposals, valid) = timed(lambda: m.proposals(feats, info, train=True, rpn_out=rpn_out))
    t_sample, (rois, roi_labels, targets, weights) = timed(lambda: m.sample(
        proposals, valid, gt, num_gt, noise["rcnn_fg"], noise["rcnn_bg"], noise["rcnn_tie"]))
    t_pool, pooled = timed(lambda: m.pool(feats, rois))
    t_head, _ = timed(lambda: m.head_losses(pooled, roi_labels, targets, weights))
    label = f"Faster R-CNN R50-FPN f32 train step, batch {FRCNN_TRAIN_B} of {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]}"
    routing_timing(label, card, rpn_targets=lambda: m.rpn_targets(feats, gt, num_gt, noise["rpn_pos"],
                                                                  noise["rpn_neg"]),
                   sampling=lambda: m.sample(proposals, valid, gt, num_gt, noise["rcnn_fg"], noise["rcnn_bg"],
                                             noise["rcnn_tie"]))
    del feats, rpn_out, pooled

    def losses_backward():
        m.zero_grad(set_to_none=True)
        model.get_losses(batch, noise=noise)[0].backward()

    t_loss, _ = timed(lambda: model.get_losses(batch, noise=noise)[0])
    t_fb, _ = timed(losses_backward)
    report = frcnn_backward_report(model, batch, noise, card)
    t_roi_bwd, nonzero = report["roi_bwd"]["ms"], report["nonzero"]
    launches = multilevel_roi_align_backward.launches
    torch.cuda.reset_peak_memory_stats()
    t_step = cuda_ms(lambda: step(state, batch), reps=reps, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    check(multilevel_roi_align_backward.launches > launches,
          "Faster R-CNN train timing ran no RoIAlign backward kernel")
    log(f"[timing] Faster R-CNN R50-FPN f32 train step, batch {FRCNN_TRAIN_B} of "
        f"{FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]}: {t_step:.3f} ms per step ({1000 * FRCNN_TRAIN_B / t_step:.2f} "
        f"img/s); stages each alone, gradients enabled: backbone+FPN {t_feat:.3f}, RPN head {t_rpn:.3f}, "
        f"RPN targets+losses {t_targets:.3f}, proposals {t_prop:.3f}, sampling {t_sample:.3f}, RoIAlign "
        f"{t_pool:.3f}, box head+losses {t_head:.3f} ms; get_losses {t_loss:.3f} ms, backward "
        f"{t_fb - t_loss:.3f} ms (of which the RoIAlign backward {t_roi_bwd:.3f} ms, timed alone on the "
        f"step's own g, {nonzero:.3f} of it nonzero), SGD {t_step - t_fb:.3f} ms (differences of means "
        f"of {reps} runs of nested prefixes); peak memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated), input already on the card | {card}")
    routing_timing(label, card, step=lambda: step(state, batch))


def phase_frcnn_timing(model, card):
    """Faster R-CNN f32 inference at batch 1 and 8 of 800x1333, input on the
    card: the whole request and its stages, each timed alone on the previous
    stage's outputs."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align

    m = model.module
    launches = multilevel_roi_align.launches
    for bs, reps in ((1, 10), (8, 3)):
        batch = _timing_batch(bs, FRCNN_IMAGE)
        total = cuda_ms(lambda: model.inference(batch), reps=reps, warmup=2)
        torch.cuda.reset_peak_memory_stats()
        model.inference(batch)
        peak = torch.cuda.max_memory_allocated()
        with torch.inference_mode(), full_f32():
            x = model.pre_process(batch)
            image, info = x["image"], x["img_info"]
            t_feat = cuda_ms(lambda: m.features(image), reps=reps, warmup=2)
            feats = m.features(image)
            t_prop = cuda_ms(lambda: m.proposals(feats, info), reps=reps, warmup=2)
            proposals, valid = m.proposals(feats, info)
            t_pool = cuda_ms(lambda: m.pool(feats, proposals), reps=reps, warmup=2)
            pooled = m.pool(feats, proposals)
            t_head = cuda_ms(lambda: m.box_head(pooled, proposals), reps=reps, warmup=2)
            boxes, scores = m.box_head(pooled, proposals)
            t_post = cuda_ms(lambda: model.post_process(boxes, scores, valid, info), reps=reps, warmup=2)
        log(f"[timing] Faster R-CNN R50-FPN f32 {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} batch {bs}: "
            f"{total:.3f} ms per batch ({1000 * bs / total:.2f} img/s); backbone+FPN {t_feat:.3f}, "
            f"RPN+proposals {t_prop:.3f}, RoIAlign {t_pool:.3f}, box head {t_head:.3f}, post-process "
            f"{t_post:.3f} ms (each alone, means of {reps}); peak memory {peak / 2**30:.2f} GiB "
            f"(torch.cuda.max_memory_allocated), input already on the card | {card}")
    check(multilevel_roi_align.launches > launches, "Faster R-CNN timing ran no RoIAlign kernel")


# -- CenterNet R50-DCNv2 and the row scatter (kernel #9) ----------------------------------------

def scatter_edges(rng):
    """Edge cases of kernel #9, on the CPU: name -> (idx (B, N) int32, values (B, N, D), R). Rows of up to
    32 entries (one chunk of ranks), 33-1024 (several) and more (the walk) take every way the
    segmentation orders a row."""
    def case(B, N, R, D, lo=0, hi=None, dtype=torch.float32):
        idx = torch.from_numpy(rng.randint(lo, R if hi is None else hi, (B, N)).astype(np.int32))
        return idx, torch.from_numpy(rng.randn(B, N, D).astype(np.float32)).to(dtype), R

    cases = {
        "all entries on one row": case(2, 2304, 289, 256),
        "about 115 entries a row (20 of 289 used)": case(2, 2304, 289, 256, 0, 20),
        "rows that receive nothing (10 of 1089 used)": case(2, 9216, 1089, 128, 0, 10),
        "indices out of range, negative and >= R": case(2, 5000, 500, 128, -600, 1100),
        "N and D off the tile (N 1001, D 1030)": case(2, 1001, 77, 1030),
        "D = 12": case(2, 2304, 289, 12),
        "B = 1, stage 3's shape": case(1, 36864, 4225, 512),
        "bf16, D = 13": case(2, 3000, 300, 13, dtype=torch.bfloat16),
        "bf16, D = 256, indices out of range": case(2, 2304, 289, 256, -20, 309, dtype=torch.bfloat16),
    }
    cases["all entries on one row"][0].fill_(7)
    return cases


def check_scatter_case(idx, values, n_rows):
    """Kernel #9 run twice and its plain version on one case on the card: the segmentation kernels
    give ``row_segments``' ids and starts, the two kernel runs give the same bits, and each output
    element lies within SCATTER_RTOL of the sum of the |values| that land on it; on bf16 values the
    bf16 output (run twice) is the plain f32 sum cast to bf16, bit for bit. Returns (worst share of
    that tolerance, max |kernel - plain|)."""
    from basedet_tpu_torch.ops.scatter_rows import row_segments, scatter_rows_plain
    from basedet_tpu_torch.ops.scatter_rows_kernel import scatter_rows, segment_rows

    order, starts = row_segments(idx, n_rows)
    ids, got = segment_rows(idx, n_rows)
    m = int(starts[-1])
    check(torch.equal(got.long(), starts) and torch.equal(ids[:m].long(), order[:m]),
          f"the segmentation kernels differ from row_segments on {tuple(values.shape)} into {n_rows} rows")
    out = scatter_rows(idx, values, n_rows)
    again = scatter_rows(idx, values, n_rows)
    torch.cuda.synchronize()
    check(torch.equal(out.view(torch.int32), again.view(torch.int32)),
          f"two runs of the scatter kernel differ on {tuple(values.shape)}")
    plain = scatter_rows_plain(idx, values, n_rows)
    if values.dtype == torch.bfloat16:
        low = [scatter_rows(idx, values, n_rows, out_dtype=torch.bfloat16) for _ in range(2)]
        want = plain.to(torch.bfloat16).view(torch.int16)
        check(all(t.dtype == torch.bfloat16 and torch.equal(t.view(torch.int16), want) for t in low),
              f"the bf16 output differs from the plain f32 sum cast to bf16 on {tuple(values.shape)}")
    mag = scatter_rows_plain(idx, values.float().abs(), n_rows)
    err = (out - plain).abs()
    ratio = torch.where(err > 0, err / (SCATTER_RTOL * mag), torch.zeros_like(err))
    return float(ratio.max()) if ratio.numel() else 0.0, float(err.max()) if err.numel() else 0.0


def scatter_bound(idx, values, n_rows, out_dtype=torch.float32):
    """(ms, "bytes" or "operations"): idx and values read once, the (B, R, D) output written once
    in ``out_dtype``; one add per value whose index lands in [0, R)."""
    B, N, D = values.shape
    landing = int(((idx >= 0) & (idx < n_rows)).sum())
    out_size = torch.empty(0, dtype=out_dtype).element_size()
    return bound(idx.numel() * idx.element_size() + values.numel() * values.element_size()
                 + B * n_rows * D * out_size, landing * D)


@torch.no_grad()
def randomise_cnet(module, generator):
    """Draw BN statistics and affine and every bias from generator, as ``randomise`` does for
    YOLOX-S, and give each DCN's offset branch random weights (zero at init, where every tap sits
    on the grid and each row of the block table receives about nine entries): then the offsets
    are fractional, some taps fall off the map and the rows receive uneven counts."""
    from basedet_tpu_torch.layers.blocks.deformable import ModulatedDeformConv

    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0.0, 0.2, generator=generator)
            m.running_var.uniform_(0.5, 2.0, generator=generator)
            m.weight.uniform_(0.5, 1.5, generator=generator)
        if isinstance(getattr(m, "bias", None), torch.Tensor):
            m.bias.add_(torch.empty_like(m.bias).normal_(0.0, 0.3, generator=generator))
        if isinstance(m, ModulatedDeformConv):
            w = m.conv_offset.weight
            w.normal_(0.0, 1.0 / math.sqrt(w[0].numel()), generator=generator)
            m.conv_offset.bias.normal_(0.0, 0.5, generator=generator)


def _cnet_opts(out_dir):
    return ["DATA.TEST.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", str(CNET_IMAGE).replace(" ", ""),
            "GLOBAL.OUTPUT_DIR", out_dir]


def _cnet_train_opts(out_dir, weights, batch=CNET_B):
    return ["DATA.TRAIN.name", "dummy", "DATA.TEST.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", str(CNET_IMAGE).replace(" ", ""),
            "MODEL.BATCHSIZE", str(batch), "SOLVER.MAX_EPOCH", "1", "SOLVER.NUM_IMAGE_PER_EPOCH",
            str(4 * batch), "GLOBAL.LOG_INTERVAL", "1", "MODEL.WEIGHTS", weights,
            "GLOBAL.OUTPUT_DIR", out_dir, "GLOBAL.CKPT_SAVE_DIR", os.path.join(out_dir, "cnet_ckpt")]


def make_cnet_weights(out_dir):
    """Full-width CenterNet R50-DCNv2 on the card with random weights from SEED, spread by
    ``randomise_cnet``, saved as a state_dict."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.tools import import_config

    cfg = import_config(CNET_CONFIG)
    cfg.merge(_cnet_opts(out_dir))
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    model = build_model(cfg, "cuda", generator)
    randomise_cnet(model.module, generator)
    weights = os.path.join(out_dir, "centernet_r50_seed0.pt")
    torch.save(model.module.state_dict(), weights)
    m = cfg.MODEL
    log(f"[cnet] {CNET_CONFIG}: {m.BACKBONE.NAME} (train-mode BN, freeze_at {m.BACKBONE.FREEZE_AT}), "
        f"DCNv2 + 4x4 deconvolution stages {m.HEAD.DECONV_CHANNEL}, heads at stride {m.HEAD.DOWN_SCALE}, "
        f"{cfg.DATA.NUM_CLASSES} classes, {sum(p.numel() for p in model.module.parameters())} "
        f"parameters, random from seed {SEED} (offset branches random)")
    return weights


def phase_cnet_train(out_dir, weights):
    """det_train on full-width CenterNet, 4 steps of 16 images of 512x512; the scatter and IoU counts
    are zeroed just before and read just after (it reaches no IoU). Keeps the first step's three scatter calls (the
    gather's row ids and, on the way back, its cotangent) and its sampling statistics."""
    from basedet_tpu_torch.layers.blocks import deformable
    from basedet_tpu_torch.models.det.centernet import CenterNet
    from basedet_tpu_torch.ops.scatter_rows import scatter_rows_plain
    from basedet_tpu_torch.ops.scatter_rows_kernel import scatter_rows, segment_rows
    from basedet_tpu_torch.tools import det_train

    kept = []

    def keep_gather(args, out):  # the first step's three DCN stages: row ids, rows, cotangent
        if len(kept) < 3:
            entry = {"idx": args[1].detach().clone(), "rows": args[0].shape[1]}
            out.register_hook(lambda g, e=entry: e.__setitem__("values", g.detach().clone()))
            kept.append(entry)

    def sampling(args, out):  # share of taps between grid points, share wholly off the map
        img, y, x = args
        H, W = img.shape[1:3]
        return (float(((y - y.floor()) > 1e-3).float().mean()),
                float(((y <= -1) | (y >= H) | (x <= -1) | (x >= W)).float().mean()))

    keep_losses = lambda args, out: {k: float(v.detach()) for k, v in out[1].items()}
    with recording(CenterNet, "get_losses", keep_losses) as losses, \
            recording(deformable, "gather_rows_batched", keep_gather), \
            recording(deformable, "bilinear_sample_batched", sampling) as taps, iou_counted("CenterNet det_train"):
        scatter_rows.launches, segment_rows.launches, scatter_rows_plain.calls = 0, 0, 0
        t0 = time.perf_counter()
        trainer = det_train.main(["-f", CNET_CONFIG, "--device", "cuda", *_cnet_train_opts(out_dir, weights)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, segments, plain_calls = scatter_rows.launches, segment_rows.launches, scatter_rows_plain.calls

    steps = trainer.state.step
    ckpt = os.path.join(out_dir, "cnet_ckpt")
    check(steps == 4 and len(losses) == 4, f"CenterNet det_train took {steps} steps, not 4")
    check(launches == 3 * steps, f"the scatter kernel launched {launches} times in {steps} steps, not 3 each")
    check(segments == launches, f"the row segmentation ran {segments} times for {launches} scatter launches")
    check(plain_calls == 0, f"the plain scatter ran {plain_calls} times on the main path")
    check_iou_counts("CenterNet det_train", 0)
    check(all(math.isfinite(v) for step in losses for v in step.values()), f"non-finite losses {losses}")
    check(all(len(step) == 4 and step["total_loss"] > 0 for step in losses), f"losses {losses}")
    check(len(kept) == 3 and all("values" in e for e in kept), "the first step's scatter calls were not seen")
    for name in ("latest.pt", "epoch_1.pt", "dumped_model.pt"):
        check(os.path.exists(os.path.join(ckpt, name)), f"CenterNet det_train wrote no {name}")
    cases = []
    for stage, e in enumerate(kept, 1):
        idx, values, rows = e["idx"], e["values"], e["rows"]
        counts = torch.bincount((idx.long() + torch.arange(idx.shape[0], device=idx.device)[:, None] * rows).flatten(),
                                minlength=idx.shape[0] * rows)
        frac, off = taps[stage - 1]
        log(f"[cnet-train] stage {stage}: scatter of {tuple(values.shape)} {str(values.dtype)[6:]} values into "
            f"R = {rows} rows: entries per row {int(counts.min())}-{int(counts.max())} (mean "
            f"{float(counts.float().mean()):.2f}), {int((counts == 0).sum())} rows empty; taps between grid "
            f"points {frac:.4f}, wholly off the map {off:.4f}")
        cases.append((f"stage {stage}", idx, values.contiguous(), rows))
    side = CNET_IMAGE[0] // 32  # res5
    check(kept[0]["values"].shape == (CNET_B, 9 * side * side, 4 * 2048),
          f"stage 1's scatter took {tuple(kept[0]['values'].shape)}, not the full-width shape")
    check(all(f > 0.5 for f, _ in taps[:3]) and any(o > 0 for _, o in taps[:3]),
          f"the offsets did not spread the taps: {taps[:3]}")
    per_step = "; ".join(", ".join(f"{k} {v:.4f}" for k, v in step.items()) for step in losses)
    log(f"[cnet-train] det_train CenterNet R50-DCNv2, 4 steps of {CNET_B} images {CNET_IMAGE[0]}x{CNET_IMAGE[1]}, "
        f"f32, in {seconds:.2f} s; scatter kernel launches {launches}, segmentations {segments}, plain calls "
        f"{plain_calls}; lr "
        f"{trainer.meters['lr'].latest:.4g}; losses per step: {per_step}; checkpoints latest.pt, epoch_1.pt, "
        f"dumped_model.pt written")
    return launches, cases, os.path.join(ckpt, "dumped_model.pt")


SEGMENT_KERNELS = ("count_rows", "scan_rows", "place_rows", "order_rows", "Memset")  # #9's segmentation


def scatter_call_timing(name, idx, values, rows, card):
    """One stage's call as the step makes it (f32 values to an f32 table, bf16 to a bf16 one): events
    for the call; from the profiler, the device time of the segmentation, the scatter kernel and any
    other operation (a cast; a sort would fail the check); the bound; the plain version; and
    ``index_add_`` (atomics, not deterministic; the port never calls it), for bf16 of the values in
    f32 with the cast to bf16 counted."""
    from basedet_tpu_torch.ops.scatter_rows import scatter_rows_plain
    from basedet_tpu_torch.ops.scatter_rows_kernel import scatter_rows

    B, N, D = values.shape
    out_dtype = values.dtype
    key = torch.where((idx >= 0) & (idx < rows), idx.long() + torch.arange(B, device="cuda")[:, None] * rows,
                      B * rows).flatten()
    flat = values.view(B * N, D)

    def library():
        table = torch.zeros(B * rows + 1, D, device="cuda").index_add_(0, key, flat.float())
        return table[:B * rows].to(out_dtype)

    call = lambda: scatter_rows(idx, values, rows, out_dtype=out_dtype)
    _, ops, found = device_kernels(call, 10, names=("scatter_rows_kernel",) + SEGMENT_KERNELS[:4])
    sorts = [k for k in found if "sort" in k.lower()]
    check(not sorts, f"a sort ran inside #9's call on {name}: {sorts}")
    seg = sum(v for k, v in found.items() if any(n in k for n in SEGMENT_KERNELS))
    kernel = sum(v for k, v in found.items() if "scatter_rows_kernel" in k)
    t = dict(ms=cuda_ms(call, reps=20, warmup=3), segment_ms=seg, kernel_ms=kernel,
             other_ms=sum(found.values()) - seg - kernel, ops=ops,
             plain_ms=cuda_ms(lambda: scatter_rows_plain(idx, values, rows, out_dtype), reps=3, warmup=1),
             library_ms=cuda_ms(library, reps=20, warmup=3))
    t["bound_ms"], t["bound_by"] = scatter_bound(idx, values, rows, out_dtype)
    device = seg + kernel + t["other_ms"]
    log(f"[scatter] {name} {tuple(values.shape)} {str(values.dtype)[6:]} -> ({B}, {rows}, {D}) "
        f"{str(out_dtype)[6:]}: call {t['ms']:.4f} ms (events); device {device:.4f} ms in {ops} operations "
        f"(profiler): segmentation {seg:.4f}, scatter kernel {kernel:.4f}, other {t['other_ms']:.4f}; bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}), the device time at {t['bound_ms'] / device:.3f} of it; plain "
        f"{t['plain_ms']:.4f}, index_add_{' of f32 values + cast' if out_dtype == torch.bfloat16 else ''} "
        f"{t['library_ms']:.4f} | {card}")
    return t


def phase_scatter_kernel(card, stages):
    """Kernel #9 against its plain version on the first train step's three calls (the step's own
    row ids and cotangents, f32, and the same cast to bf16) and on edge cases, two kernel runs
    bit-equal each time, the segmentation equal to ``row_segments`` and the bf16 output to the plain
    f32 sum cast; then each stage timed in f32 and in bf16 (``scatter_call_timing``) and summed over
    the three calls of a step. Returns the f32 step's numbers with the bf16 step's under "bf16"."""
    cases = list(stages) + [(f"{name} bf16", idx, values.bfloat16(), rows) for name, idx, values, rows in stages]
    cases += [(name, idx.cuda(), values.cuda(), rows)
              for name, (idx, values, rows) in scatter_edges(np.random.RandomState(SEED + 9)).items()]
    worst, worst_err = 0.0, 0.0
    for name, idx, values, rows in cases:
        ratio, err = check_scatter_case(idx, values, rows)
        worst, worst_err = max(worst, ratio), max(worst_err, err)
        log(f"[scatter] {name}: {tuple(values.shape)} {str(values.dtype)[6:]} into {rows} rows: max |kernel - "
            f"plain| {err:.3e}, {ratio:.3f} of the tolerance (SCATTER_RTOL {SCATTER_RTOL:.3e} x sum |values| "
            f"per element); two kernel runs bit-equal; segmentation equal to row_segments"
            f"{'; bf16 output bit-equal to the plain sum cast' if values.dtype == torch.bfloat16 else ''}")
        check(ratio <= 1.0, f"scatter kernel against its plain version on {name}: {ratio:.3f} of the tolerance")

    keys = ("ms", "segment_ms", "kernel_ms", "other_ms", "plain_ms", "library_ms", "bound_ms")
    steps = {}
    for dtype in (torch.float32, torch.bfloat16):
        step, by = dict.fromkeys(keys, 0.0), []
        for name, idx, values, rows in stages:
            t = scatter_call_timing(name, idx, values.to(dtype), rows, card)
            by.append(t["bound_by"])
            for k in keys:
                step[k] += t[k]
        device = step["segment_ms"] + step["kernel_ms"] + step["other_ms"]
        log(f"[scatter] per train step at batch {CNET_B} of {CNET_IMAGE[0]}x{CNET_IMAGE[1]}, "
            f"{str(dtype)[6:]} (3 calls): call {step['ms']:.4f} ms (events); device {device:.4f} ms: segmentation "
            f"{step['segment_ms']:.4f}, scatter kernel {step['kernel_ms']:.4f}, other {step['other_ms']:.4f}; bound "
            f"{step['bound_ms']:.4f} ms, the device time at {step['bound_ms'] / device:.3f} of it; plain "
            f"{step['plain_ms']:.4f}, index_add_ {step['library_ms']:.4f}; worst case {worst:.3f} of the tolerance "
            f"| {card}")
        steps[dtype] = dict(step, device_ms=device, bound_by=max(set(by), key=by.count))
    f32, bf16 = steps[torch.float32], steps[torch.bfloat16]
    numbers = ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms")
    return dict(max_abs_err=worst_err, **{k: f32[k] for k in numbers}, bound_by=f32["bound_by"],
                bf16={k: bf16[k] for k in numbers})


def phase_cnet_slice(out_dir, weights):
    """det_test on full-width CenterNet over 8 requests of one 512x512 image."""
    from basedet_tpu_torch.tools import det_test

    t0 = time.perf_counter()
    with iou_counted("CenterNet det_test"):
        results = det_test.main(["-f", CNET_CONFIG, "-w", weights, "--device", "cuda", *_cnet_opts(out_dir)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with open(os.path.join(out_dir, "predict_coco.json")) as f:
        records = json.load(f)
    check(len(records) >= 1, "CenterNet det_test gave no detections")
    check(np.isfinite([r["bbox"] + [r["score"]] for r in records]).all(), "non-finite detections")
    check({r["image_id"] for r in records} == set(range(8)), "not every request was answered")
    iou = check_iou_counts("CenterNet det_test", 0)
    log(f"[cnet] det_test CenterNet R50-DCNv2 with {os.path.basename(weights)} on 8 requests of "
        f"{CNET_IMAGE[0]}x{CNET_IMAGE[1]}: {results}, {len(records)} finite detections in {seconds:.2f} s; {iou}")


def _cnet_train_setup(weights, device, batch):
    """Full-width CenterNet in train mode with ``weights``, its train state and step, and the first
    synthetic batch of ``batch`` 512x512 images."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.data import DataloaderBuilder
    from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
    from basedet_tpu_torch.solver import DetSolver
    from basedet_tpu_torch.tools import import_config

    cfg = import_config(CNET_CONFIG)
    cfg.merge(_cnet_train_opts(".", weights, batch))
    model = build_model(cfg, device)
    model.load_weights(weights)
    solver = DetSolver.build(cfg)
    state = TrainState(model.train(), solver)
    return model, state, make_train_step(model, solver, cfg), next(DataloaderBuilder.build(cfg))


def phase_cnet_card_vs_cpu(weights):
    """CenterNet card against CPU, f32, TF32 off, on one batch of 2 at full width: the eval-mode
    head outputs and detections, then one train forward and backward: losses, gradient norm and
    the new BN running statistics."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.ops.scatter_rows_kernel import scatter_rows
    from basedet_tpu_torch.utils.compare import match_detections

    runs = {}
    for device in ("cpu", "cuda"):
        model, _, _, batch = _cnet_train_setup(weights, device, CNET_PARITY_B)
        request = {k: batch[k] for k in ("data", "im_info")}
        t0 = time.perf_counter()
        model.eval()
        with torch.inference_mode(), full_f32():
            m = model.module
            y = m.features(model.pre_process(request)["image"])
            stages = {"res5": y.cpu()}
            for i, stage in enumerate(m.upsample.stages(), 1):
                y = stage(y)
                stages[f"deconv{i}"] = y.cpu()
            heads = {k: v.cpu() for k, v in m.heads(y).items()}
        dets = {k: v.cpu().numpy() for k, v in model.inference(request).items()}
        model.train()
        launches = scatter_rows.launches
        model.module.zero_grad(set_to_none=True)
        with full_f32():  # the backward too, as the train step holds it
            total, losses = model.get_losses(batch)
            total.backward()
        norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in model.module.parameters())))
        stats = {k: v.double().cpu() for k, v in model.module.state_dict().items() if "running" in k}
        runs[device] = dict(heads=heads, stages=stages, dets=dets,
                            losses={k: float(v.detach()) for k, v in losses.items()},
                            norm=norm, stats=stats, launches=scatter_rows.launches - launches,
                            seconds=time.perf_counter() - t0)
    cpu, gpu = runs["cpu"], runs["cuda"]
    head_err = {k: (float((gpu["heads"][k] - v).abs().max()), float(v.abs().max())) for k, v in cpu["heads"].items()}
    worst_head = max(err for err, _ in head_err.values())
    stage_err = {k: float((gpu["stages"][k] - v).abs().max() / v.abs().max()) for k, v in cpu["stages"].items()}
    frac = match_detections(cpu["dets"], gpu["dets"])
    rel = {k: abs(gpu["losses"][k] - v) / max(abs(v), 1e-12) for k, v in cpu["losses"].items()}
    norm_rel = abs(gpu["norm"] - cpu["norm"]) / cpu["norm"]
    stats_rel = max(float(((gpu["stats"][k] - v).abs() / v.abs().clamp(min=1.0)).max())
                    for k, v in cpu["stats"].items())
    log(f"[parity] CenterNet card vs CPU, f32, batch {CNET_PARITY_B} of {CNET_IMAGE[0]}x{CNET_IMAGE[1]} (CPU run "
        f"{cpu['seconds']:.1f} s, plain scatter; card scatter launches {gpu['launches']}): eval features, max |diff| "
        f"over max |value|: {', '.join(f'{k} {v:.3e}' for k, v in stage_err.items())}; heads max |diff| (max |value|) "
        f"{', '.join(f'{k} {e:.3e} ({v:.3e})' for k, (e, v) in head_err.items())} (tol {HEAD_ATOL}); "
        f"{int(cpu['dets']['valid'].sum())} CPU / "
        f"{int(gpu['dets']['valid'].sum())} card detections, {frac:.4f} matched (label, IoU >= 0.999, |dscore| "
        f"<= 1e-4); train losses card {', '.join(f'{k} {v:.6f}' for k, v in gpu['losses'].items())} / CPU "
        f"{', '.join(f'{k} {v:.6f}' for k, v in cpu['losses'].items())}, worst rel diff {max(rel.values()):.3e} "
        f"(tol {LOSS_RTOL}); gradient norm {gpu['norm']:.6f} card / {cpu['norm']:.6f} CPU, rel diff "
        f"{norm_rel:.3e} (tol {GRAD_NORM_RTOL}); new BN running statistics differ by {stats_rel:.3e} of "
        f"max(|value|, 1) (tol {STATS_RTOL})")
    check(gpu["launches"] == 3, f"the card's train backward launched the scatter kernel {gpu['launches']} times")
    check(worst_head <= HEAD_ATOL, f"CenterNet head outputs differ between card and CPU: {head_err}")
    check(np.isfinite(gpu["dets"]["boxes"]).all() and gpu["dets"]["valid"].any(),
          "card detections empty or non-finite")
    check(frac >= 0.95, f"only {frac:.3f} of the CPU's CenterNet detections matched on the card")
    check(all(math.isfinite(v) for v in gpu["losses"].values()), "non-finite CenterNet losses on the card")
    check(max(rel.values()) <= LOSS_RTOL, f"CenterNet train losses differ between card and CPU: {rel}")
    check(norm_rel <= GRAD_NORM_RTOL, f"CenterNet gradient norms differ by {norm_rel:.3e}")
    check(stats_rel <= STATS_RTOL, f"CenterNet BN running statistics differ by {stats_rel:.3e}")


def phase_cnet_train_timing(weights, card, scatter_step_ms):
    """One f32 CenterNet train step at batch 16 of 512x512 (input already on the card): backbone,
    each deconvolution stage, heads, and targets + losses, each timed alone on the previous
    stage's outputs with gradients enabled; get_losses, get_losses with backward and the whole
    step as nested prefixes; the three scatter calls' share of the backward from the kernel
    phase; peak memory. Returns (step ms, a function running one step)."""
    from basedet_tpu_torch.layers.common.function import full_f32

    model, state, step, batch = _cnet_train_setup(weights, "cuda", CNET_B)
    batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    m, reps = model.module, MODEL_REPS

    def timed(fn):
        def run():
            with full_f32():
                return fn()
        return cuda_ms(run, reps=reps, warmup=2), run()

    x = model.pre_process(batch, train=True)
    t_backbone, y = timed(lambda: m.features(x["image"]))
    t_stages = []
    for stage in m.upsample.stages():
        t, y = timed(lambda y=y, stage=stage: stage(y))
        t_stages.append(t)
    t_heads, pred = timed(lambda: m.heads(y))
    t_losses, _ = timed(lambda: model.losses(pred, x["img_info"], x["gt_boxes"]))
    del y, pred

    def losses_backward():
        m.zero_grad(set_to_none=True)
        model.get_losses(batch)[0].backward()

    t_loss, _ = timed(lambda: model.get_losses(batch)[0])
    t_fb, _ = timed(losses_backward)
    torch.cuda.reset_peak_memory_stats()
    t_step = cuda_ms(lambda: step(state, batch), reps=reps, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    t_bwd = t_fb - t_loss
    log(f"[timing] CenterNet R50-DCNv2 f32 train step, batch {CNET_B} of {CNET_IMAGE[0]}x{CNET_IMAGE[1]}: "
        f"{t_step:.3f} ms per step ({1000 * CNET_B / t_step:.2f} img/s); each alone, gradients enabled: backbone "
        f"{t_backbone:.3f}, deconvolution stages {', '.join(f'{t:.3f}' for t in t_stages)}, heads {t_heads:.3f}, "
        f"targets+losses {t_losses:.3f} ms; get_losses {t_loss:.3f} ms, backward {t_bwd:.3f} ms (of which the "
        f"three scatter calls {scatter_step_ms:.3f} ms, {scatter_step_ms / t_bwd:.3f} of it, timed alone on the "
        f"first det_train step's own arguments), SGD {t_step - t_fb:.3f} ms (differences of means of {reps} "
        f"runs of nested prefixes); peak memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated), input "
        f"already on the card | {card}")
    return t_step, lambda: step(state, batch)


# -- RetinaNet R50-FPN and pairwise IoU (kernel #10) ---------------------------------------------

def _iou_boxes(rng, shape, size=200.0):
    """Random xyxy f32 boxes of ``shape`` (..., 4) on a canvas of ``size``, sides 1 to size / 3, as
    tests/ops/test_iou_pallas.py draws them."""
    xy = rng.uniform(0, size, shape[:-1] + (2,))
    wh = rng.uniform(1, size / 3, shape[:-1] + (2,))
    return torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32))


def _overlapping(rng, shape, centre, reach):
    """xyxy f32 boxes of ``shape`` (..., 4) that all contain the point ``centre``: each side lies 1
    to ``reach`` from it, so every pair of them intersects and the kernel's skip never fires."""
    d = rng.uniform(1, reach, shape)
    cx, cy = centre
    return torch.from_numpy(np.stack([cx - d[..., 0], cy - d[..., 1], cx + d[..., 2], cy + d[..., 3]],
                                     -1).astype(np.float32))


def iou_edges(rng):
    """Edge cases of kernel #10, on the CPU: name -> (boxes1, boxes2). The special boxes meet each
    other in zero-area, inverted (union <= 0), identical (IoU exactly 1), touching-edge and disjoint
    pairs, and at coordinates up to 1e4. Then -0.0 coordinates, where a difference is exactly -0.0
    and the plain version's zero takes its sign from max(-0.0, 0) (+0.0 on the H100, -0.0 in
    PyTorch on the CPU; the kernel never skips a row or strip that holds one), among zero-padded
    rows that the skip takes in the strip without one; and a set in which every pair overlaps (no
    skip at all)."""
    special = torch.tensor([
        [10, 10, 10, 30],  # zero width
        [10, 10, 30, 10],  # zero height
        [5, 5, 5, 5],  # a point
        [30, 30, 10, 10],  # inverted in x and y: area +400
        [30, 10, 10, 40],  # inverted in x: area -600, so unions with it fall to <= 0
        [10, 10, 30, 30],  # identical to itself: IoU exactly 1
        [30, 10, 50, 30],  # touches [10, 10, 30, 30] along x = 30
        [10, 30, 30, 50],  # touches it along y = 30
        [300, 300, 320, 320],  # disjoint from all but itself
        [0, 0, 1e4, 1e4],
        [9990.5, 9990.25, 1e4, 1e4],
        [1234.5, 9000, 9876.25, 9999.75],
    ], dtype=torch.float32)
    mixed = torch.cat([special, _iou_boxes(rng, (20, 4))])
    neg0 = torch.tensor([
        [0, 0, 10, -0.0],  # against [0, 0, 10, 10]: ih = max(-0.0 - 0, 0), union 100, IoU a zero
        [0, 0, -0.0, 10],  # the same in x
        [-0.0, -0.0, 10, 10],  # max(-0.0, 0) on the left of each difference
        [0, 0, 10, 10],
    ], dtype=torch.float32)
    rows = torch.cat([neg0, torch.zeros(12, 4), _iou_boxes(rng, (24, 4))])  # -0.0 in 3 rows, 12 gt padding rows
    return {
        "zero-area, inverted, identical, touching, disjoint, 1e4 (2, 32) x (1030,)":
            (torch.stack([mixed, mixed.flip(0)]), torch.cat([special, _iou_boxes(rng, (1018, 4), 1e4)])),
        "M = 1, N = 4097 (off the block and off 4)": (_iou_boxes(rng, (1, 4)), _iou_boxes(rng, (4097, 4))),
        "boxes2 per image (3, 17) x (3, 1021)": (_iou_boxes(rng, (3, 17, 4)), _iou_boxes(rng, (3, 1021, 4))),
        "one set against itself (257,) x (257,)": (mixed.repeat(9, 1)[:257], mixed.repeat(9, 1)[:257]),
        "-0.0 coordinates among zero rows (2, 40) x (300,)":
            (torch.stack([rows, rows.flip(0)]), torch.cat([neg0, _iou_boxes(rng, (124, 4)), neg0.flip(0),
                                                            _iou_boxes(rng, (168, 4))])),
        "dense: every pair overlaps (2, 37) x (2, 515)":
            (_overlapping(rng, (2, 37, 4), (100.0, 100.0), 90.0), _overlapping(rng, (2, 515, 4), (100.0, 100.0), 90.0)),
    }


def check_iou_case(boxes1, boxes2):
    """Kernel #10 and its plain version on one case on the card: (max |kernel - plain|, whether
    the two are bit-equal)."""
    from basedet_tpu_torch.ops.iou_kernel import box_iou, box_iou_plain

    got = box_iou(boxes1, boxes2)
    torch.cuda.synchronize()
    ref = box_iou_plain(boxes1, boxes2)
    check(got.shape == ref.shape, f"IoU kernel gave {tuple(got.shape)}, plain {tuple(ref.shape)}")
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    return err, bool(torch.equal(got.view(torch.int32), ref.view(torch.int32)))


def iou_bound(boxes1, boxes2):
    """(ms, "bytes" or "operations"): both box sets read once, the f32 output written once; ~17
    f32 operations per pair (4 min/max, 2 differences, 2 clamps, the product, the two sums, the
    compare, the max and the quotient, and the two areas' 3 operations each, amortised)."""
    B = boxes1.shape[0] if boxes1.dim() == 3 else 1
    pairs = B * boxes1.shape[-2] * boxes2.shape[-2]
    return bound(4 * pairs + 4 * boxes1.numel() + 4 * boxes2.numel(), 17 * pairs)


@torch.no_grad()
def randomise_retina(module, generator):
    """Draw the frozen BN statistics and affine and every bias from generator, as
    ``randomise_frcnn`` does; spread the class logits' biases by 2 around the prior (-4.6), so that
    some (anchor, class) scores clear the 0.05 threshold (at the prior every score is ~0.01 and NMS
    would see nothing), and raise the box-size regression by log 2, so that a box spans twice its
    anchor and same-class neighbours overlap: NMS then suppresses on the main path."""
    from basedet_tpu_torch.layers.common.blocks import FrozenBatchNorm

    for m in module.modules():
        if isinstance(m, FrozenBatchNorm):
            m.running_mean.normal_(0.0, 0.2, generator=generator)
            m.running_var.uniform_(0.5, 2.0, generator=generator)
            m.weight.uniform_(0.5, 1.5, generator=generator)
        if getattr(m, "bias", None) is not None:
            m.bias.add_(torch.empty_like(m.bias).normal_(0.0, 0.3, generator=generator))
    head = module.head
    head.cls_score.bias.add_(torch.empty_like(head.cls_score.bias).normal_(0.0, 2.0, generator=generator))
    head.bbox_pred.bias.view(-1, 4)[:, 2:].add_(math.log(2.0))  # (dx, dy, dw, dh) per anchor


def _retina_opts(out_dir):
    return ["DATA.TEST.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", str(FRCNN_IMAGE).replace(" ", ""),
            "GLOBAL.OUTPUT_DIR", out_dir]


def _retina_train_opts(out_dir, weights):
    return ["DATA.TRAIN.name", "dummy", "DATA.TEST.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", str(FRCNN_IMAGE).replace(" ", ""),
            "MODEL.BATCHSIZE", str(RETINA_B), "SOLVER.MAX_EPOCH", "1", "SOLVER.NUM_IMAGE_PER_EPOCH",
            str(4 * RETINA_B), "GLOBAL.LOG_INTERVAL", "1", "MODEL.WEIGHTS", weights, "GLOBAL.OUTPUT_DIR",
            out_dir, "GLOBAL.CKPT_SAVE_DIR", os.path.join(out_dir, "retina_ckpt")]


def make_retina_weights(out_dir):
    """Full-width RetinaNet R50-FPN on the card with random weights from SEED, spread by
    ``randomise_retina``, saved as a state_dict. Returns (cfg for det_test, model, path)."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.tools import import_config

    cfg = import_config(RETINA_CONFIG)
    cfg.merge(_retina_opts(out_dir))
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    model = build_model(cfg, "cuda", generator)
    randomise_retina(model.module, generator)
    weights = os.path.join(out_dir, "retinanet_r50_seed0.pt")
    torch.save(model.module.state_dict(), weights)
    m = cfg.MODEL
    log(f"[retina] {RETINA_CONFIG}: {m.BACKBONE.NAME} (FrozenBN, freeze_at {m.BACKBONE.FREEZE_AT}), FPN "
        f"P3-P7 {m.FPN.OUT_CHANNELS} (p6p7 on {m.FPN.TOP_BLOCK_IN_FEATURE}), "
        f"{model.anchor_gen.num_anchors} anchors per location, {m.HEAD.NUM_CONVS}-conv head, "
        f"{cfg.DATA.NUM_CLASSES} classes, {sum(p.numel() for p in model.module.parameters())} parameters, "
        f"random from seed {SEED}")
    return cfg, model, weights


def low_quality_counts(matcher, matrix, row_valid, labels):
    """(foreground, ignored, the low-quality rule's picks: anchors equal to a valid gt's best IoU, ties
    included, and those of them whose own best IoU is under the foreground threshold, foreground by
    the rule alone) of one Matcher call."""
    masked = torch.where(row_valid[:, :, None], matrix, -1.0)
    picks = ((masked == masked.amax(2, keepdim=True)) & row_valid[:, :, None]).any(1)
    low = picks & (masked.amax(1) < matcher.thresholds[-1])
    return int((labels > 0).sum()), int((labels == -1).sum()), int(picks.sum()), int(low.sum())


def phase_retina_train(out_dir, weights):
    """det_train on full-width RetinaNet, 4 steps of 2 images of 800x1333; the IoU kernel's and its
    plain version's counts are zeroed just before and read just after. Keeps every step's IoU
    arguments (gts and anchors) and, per step, the foreground, ignored and low-quality matches."""
    from basedet_tpu_torch.layers.common.matcher import Matcher
    from basedet_tpu_torch.models.det import retinanet
    from basedet_tpu_torch.models.det.retinanet import RetinaNet
    from basedet_tpu_torch.tools import det_train

    def assigned(args, out):  # foreground, ignored, the low-quality rule's picks and those under the threshold
        return low_quality_counts(*args, out[1])

    keep_losses = lambda args, out: {k: float(v.detach()) for k, v in out[1].items()}
    with recording(retinanet, "box_iou", lambda args, out: tuple(a.clone() for a in args)) as iou_calls, \
            recording(Matcher, "__call__", assigned) as assignments, \
            recording(RetinaNet, "get_losses", keep_losses) as losses, iou_counted("RetinaNet det_train"):
        t0 = time.perf_counter()
        trainer = det_train.main(["-f", RETINA_CONFIG, "--device", "cuda", *_retina_train_opts(out_dir, weights)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0

    steps = trainer.state.step
    ckpt = os.path.join(out_dir, "retina_ckpt")
    check(steps == 4 and len(losses) == 4, f"RetinaNet det_train took {steps} steps, not 4")
    iou = check_iou_counts("RetinaNet det_train", steps)
    check(all(math.isfinite(v) for step in losses for v in step.values()), f"non-finite losses {losses}")
    check(all(len(step) == 3 and step["total_loss"] > 0 for step in losses), f"losses {losses}")
    check(len(assignments) == steps and all(fg > 0 and ign > 0 and picks > 0 for fg, ign, picks, _ in assignments),
          f"a step had no foreground, no ignored anchors or no low-quality pick: {assignments}")
    gts, anchors = iou_calls[0]
    check(tuple(gts.shape) == (RETINA_B, 100, 4) and tuple(anchors.shape) == (RETINA_ANCHORS, 4),
          f"the IoU took {tuple(gts.shape)} x {tuple(anchors.shape)}, not the full-width shape")
    for name in ("latest.pt", "epoch_1.pt", "dumped_model.pt"):
        check(os.path.exists(os.path.join(ckpt, name)), f"RetinaNet det_train wrote no {name}")
    per_step = "; ".join(", ".join(f"{k.replace('_loss', '')} {v:.4f}" for k, v in step.items()) for step in losses)
    log(f"[retina-train] det_train RetinaNet R50-FPN, 4 steps of {RETINA_B} images {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} "
        f"(padded 800x1344), f32, in {seconds:.2f} s; {iou} at {tuple(gts.shape)} x {tuple(anchors.shape)}; lr "
        f"{trainer.meters['lr'].latest:.4g}; losses per step: "
        f"{per_step}; per step (foreground, ignored, the low-quality rule's picks, those of them under the "
        f"0.5 threshold) of {RETINA_B * RETINA_ANCHORS} anchors: {assignments}; checkpoints latest.pt, epoch_1.pt, dumped_model.pt written")
    return iou_calls[0], os.path.join(ckpt, "dumped_model.pt")


def _coco_like_boxes(rng, B, K, h, w):
    """(B, K, 4) f32 gt boxes of COCO-like sizes on an h x w image: small, medium and large in
    COCO's shares of instances (41%, 34%, 24%; sqrt(area) log-uniform in [8, 32), [32, 96) and
    [96, 640)), aspect ratios log-uniform in [1/3, 3], centres uniform, clipped to the image."""
    size_class = rng.choice(3, (B, K), p=[0.41, 0.34, 0.25])
    lo, hi = np.log([8.0, 32.0, 96.0])[size_class], np.log([32.0, 96.0, 640.0])[size_class]
    side = np.exp(rng.uniform(lo, hi))
    aspect = np.exp(rng.uniform(np.log(1 / 3), np.log(3), (B, K)))
    bw, bh = side * np.sqrt(aspect), side / np.sqrt(aspect)
    cx, cy = rng.uniform(0, w, (B, K)), rng.uniform(0, h, (B, K))
    boxes = np.stack([np.clip(cx - bw / 2, 0, w), np.clip(cy - bh / 2, 0, h), np.clip(cx + bw / 2, 0, w),
                      np.clip(cy + bh / 2, 0, h)], -1)
    return torch.from_numpy(boxes.astype(np.float32))


def parent_iou(source):
    """Kernel #10 of another tree, built from its ``csrc/iou.cu`` with this tree's flags and called
    through the same C entry as this tree's wrapper calls: a function of (boxes1, boxes2) on the
    card."""
    import ctypes
    from pathlib import Path

    from basedet_tpu_torch.ops import _build

    fn = ctypes.CDLL(str(_build.build_library(Path(source).resolve())[0])).basedet_box_iou
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(boxes1, boxes2):
        flat = boxes1.dim() == 2
        b1, b2 = (boxes1[None] if flat else boxes1).contiguous(), boxes2.contiguous()
        B, M, N = b1.shape[0], b1.shape[1], b2.shape[-2]
        out = torch.empty(B, M, N, dtype=torch.float32, device=b1.device)
        err = fn(b1.data_ptr(), b2.data_ptr(), B, M, N, N * 4 if b2.dim() == 3 else 0, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"the parent's IoU kernel failed to launch: CUDA error {err}")
        return out[0] if flat else out

    return call


def _iou_device_ms(fn):
    return device_ms(fn, 20, ("iou_kernel",))["iou_kernel"]


def phase_iou_kernel(card, step_calls, parent_source=None):
    """Kernel #10 against its plain version, bit for bit (the sign of zero included), on the main
    paths' own arguments (``step_calls``: RetinaNet's gts and anchors, Faster R-CNN's RPN targets
    and R-CNN sampling, YOLOX's SimOTA, each of its det_train's first step), on 100 gts of COCO-like
    sizes per image against the RPN's anchors, on a case where every pair overlaps (the skip never
    fires), on the 2-D (300, 130) of tests/ops/test_iou_pallas.py and on the edge cases; two runs
    bit-equal. Each timed case: device time (profiler) and events of the kernel, the plain
    version's events, the bound and the share of (row, strip) pairs the kernel computes in full
    (``iou_skip_mask``). With ``parent_source`` (another tree's csrc/iou.cu), that kernel is built,
    held to the plain version on the same cases and timed beside this one in turns (parent,
    change, change, parent)."""
    from basedet_tpu_torch.layers.common.anchor_generator import DefaultAnchorGenerator
    from basedet_tpu_torch.ops.iou_kernel import STRIP_COLS, box_iou, box_iou_plain, iou_skip_mask
    from basedet_tpu_torch.tools import import_config

    rng = np.random.RandomState(SEED + 10)
    m = import_config(FRCNN_CONFIG).MODEL
    rpn_gen = DefaultAnchorGenerator(tuple(map(tuple, m.ANCHOR.SCALES)), tuple(map(tuple, m.ANCHOR.RATIOS)),
                                     tuple(m.FPN.STRIDES), m.ANCHOR.OFFSET)
    rpn_anchors = torch.cat(rpn_gen([*ROI_LEVELS, (13, 21)], "cuda"))
    check(rpn_anchors.shape[0] == FRCNN_ANCHORS, f"{rpn_anchors.shape[0]} Faster R-CNN anchors")
    h, w = FRCNN_IMAGE
    timed = {
        **step_calls,
        "COCO-like: 100 gts per image x the RPN anchors": (_coco_like_boxes(rng, FRCNN_TRAIN_B, 100, h, w).cuda(),
                                                          rpn_anchors),
        "dense: every pair overlaps": (_overlapping(rng, (RETINA_B, 100, 4), (w / 2, h / 2), h / 2).cuda(),
                                       _overlapping(rng, (RETINA_ANCHORS, 4), (w / 2, h / 2), h / 2).cuda()),
        "2-D (300, 130)": (_iou_boxes(rng, (300, 4)).cuda(), _iou_boxes(rng, (130, 4)).cuda()),
    }
    parent = parent_iou(parent_source) if parent_source else None
    worst, parent_bits = 0.0, []
    cases = {**timed, **{k: (a.cuda(), b.cuda()) for k, (a, b) in iou_edges(rng).items()}}
    for name, (b1, b2) in cases.items():
        err, bits = check_iou_case(b1, b2)
        again = box_iou(b1, b2)
        repeat = torch.equal(again.view(torch.int32), box_iou(b1, b2).view(torch.int32))
        worst = max(worst, err)
        log(f"[iou] {name}: {tuple(b1.shape)} x {tuple(b2.shape)}: max |kernel - plain| {err:.3e}, "
            f"bit-equal {bits}, two runs bit-equal {repeat}")
        check(bits, f"IoU kernel against its plain version on {name}: not bit-equal (max |diff| {err:.3e})")
        check(repeat, f"two runs of the IoU kernel differ on {name}")
        if parent is not None:
            ref = box_iou_plain(b1, b2)
            parent_bits.append((name, torch.equal(parent(b1, b2).view(torch.int32), ref.view(torch.int32))))
    b1, _ = cases["one set against itself (257,) x (257,)"]
    proper = (b1[:, 2] > b1[:, 0]) & (b1[:, 3] > b1[:, 1])
    check(bool((box_iou(b1, b1).diagonal()[proper] == 1.0).all()), "a box against itself is not IoU 1")
    if parent is not None:
        log(f"[iou] the parent's kernel ({parent_source}) bit-equal to the plain version: {parent_bits}")
    out = {}
    for name, (b1, b2) in timed.items():
        call = lambda: box_iou(b1, b2)
        ms = cuda_ms(call, reps=20, warmup=3)
        plain_ms = cuda_ms(lambda: box_iou_plain(b1, b2), reps=5, warmup=1)
        bound_ms, bound_by = iou_bound(b1, b2)
        dense = 1.0 - float(iou_skip_mask(b1, b2).float().mean())
        if parent is None:
            device = [_iou_device_ms(call)]
            turns = ""
        else:
            old = lambda: parent(b1, b2)
            order = (old, call, call, old)
            dev = [_iou_device_ms(f) for f in order]
            events = [cuda_ms(f, reps=20, warmup=3) for f in order]
            device = dev[1:3]
            turns = (f"; parent, change, change, parent: device {', '.join(f'{t:.4f}' for t in dev)} ms, "
                     f"events {', '.join(f'{t:.4f}' for t in events)} ms")
        out[name] = dict(ms=ms, device_ms=min(device), plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        log(f"[iou] {name} {tuple(b1.shape)} x {tuple(b2.shape)}: kernel device {min(device):.4f}-"
            f"{max(device):.4f} ms (profiler), events {ms:.4f} ms; plain {plain_ms:.4f} ms; bound {bound_ms:.4f} "
            f"ms ({bound_by}), device time at {bound_ms / min(device):.2f} of it; {dense:.4f} of the (row, "
            f"{STRIP_COLS}-column strip) pairs computed in full{turns} | {card}")
    log(f"[iou] {len(cases)} cases bit-equal to the plain version, two runs bit-equal")
    retina = out["RetinaNet det_train (gts, anchors)"]
    return dict(max_abs_err=worst, library_ms=None, **{k: retina[k] for k in ("ms", "plain_ms", "bound_ms",
                                                                                 "bound_by")})


def phase_retina_slice(out_dir, weights):
    """det_test on full-width RetinaNet over 8 requests of one 800x1333 image; the NMS and IoU counts
    are zeroed just before and read just after (it reaches no IoU)."""
    from basedet_tpu_torch.ops import nms as nms_ops
    from basedet_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain
    from basedet_tpu_torch.tools import det_test

    seen = lambda args, keep: (args[0].shape[1], list(zip(args[1].sum(1).tolist(), keep.sum(1).tolist())))
    nms_keep.launches, nms_keep_plain.calls = 0, 0
    t0 = time.perf_counter()
    with recording(nms_ops, "nms_keep", seen) as calls, iou_counted("RetinaNet det_test"):
        results = det_test.main(["-f", RETINA_CONFIG, "-w", weights, "--device", "cuda", *_retina_opts(out_dir)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, plain_calls = nms_keep.launches, nms_keep_plain.calls
    with open(os.path.join(out_dir, "predict_coco.json")) as f:
        records = json.load(f)
    check(len(records) >= 1, "RetinaNet det_test gave no detections")
    check(np.isfinite([r["bbox"] + [r["score"]] for r in records]).all(), "non-finite detections")
    check({r["image_id"] for r in records} == set(range(8)), "not every request was answered")
    check(launches == 8, f"the NMS kernel launched {launches} times for 8 requests")
    check(plain_calls == 0, f"the plain NMS ran {plain_calls} times on the main path")
    check_iou_counts("RetinaNet det_test", 0)
    check(all(k == RETINA_FINAL_K for k, _ in calls), f"NMS took {[k for k, _ in calls]} candidates, not 5000")
    check(any(k < v for _, call in calls for v, k in call), "NMS suppressed nothing on the main path")
    log(f"[retina] det_test RetinaNet R50-FPN with {os.path.basename(weights)} on 8 requests of "
        f"{FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} (padded 800x1344): {results}, {len(records)} finite detections in "
        f"{seconds:.2f} s; NMS kernel launches {launches} at K = {RETINA_FINAL_K}, plain calls {plain_calls}; "
        f"NMS kept per image {_kept_range([call for _, call in calls])}")
    return launches


def _retina_train_setup(weights, device):
    """Full-width RetinaNet in train mode with ``weights``, its train state and step, and the first
    synthetic batch of 2 images of 800x1333."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.data import DataloaderBuilder
    from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
    from basedet_tpu_torch.solver import DetSolver
    from basedet_tpu_torch.tools import import_config

    cfg = import_config(RETINA_CONFIG)
    cfg.merge(_retina_train_opts(".", weights))
    model = build_model(cfg, device)
    model.load_weights(weights)
    solver = DetSolver.build(cfg)
    state = TrainState(model.train(), solver)
    return model, state, make_train_step(model, solver, cfg), next(DataloaderBuilder.build(cfg))


def _retina_stages(model, request):
    """res3-res5, P3-P7 and the per-level head outputs of one eval request, and its detections,
    on the CPU."""
    from basedet_tpu_torch.layers.common.function import full_f32

    m = model.module.eval()
    with torch.inference_mode(), full_f32():
        bottom_up = m.bottom_up(model.pre_process(request)["image"])
        feats = m.fpn(bottom_up)
        logits, offsets = m.head([feats[n] for n in m.level_names])
    stages = {**{k: v.cpu() for k, v in bottom_up.items()}, **{k: feats[k].cpu() for k in m.level_names},
              **{f"logits {n}": x.cpu() for n, x in zip(m.level_names, logits)},
              **{f"offsets {n}": x.cpu() for n, x in zip(m.level_names, offsets)}}
    return stages, {k: v.cpu().numpy() for k, v in model.inference(request).items()}


def _retina_train_pass(model, batch):
    """One train forward and backward at full width: anchor labels, losses, gradient norm, on the
    CPU."""
    from basedet_tpu_torch.layers.common.function import full_f32

    model.train()
    with full_f32():
        x = model.pre_process(batch, train=True)
        logits_l, offsets_l = model.module(x["image"])
        anchors = torch.cat(model.anchors(logits_l), dim=0)
        labels, gt_offsets = model.ground_truth(anchors, x["gt_boxes"], x["img_info"][:, 4].long())
        logits, offsets = (torch.cat(v, dim=1) for v in model.flatten(logits_l, offsets_l))
        losses = model.losses(logits, offsets, labels, gt_offsets)
        model.module.zero_grad(set_to_none=True)
        losses["total_loss"].backward()
    norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in model.module.parameters()
                                if p.grad is not None)))
    return labels.cpu(), {k: float(v.detach()) for k, v in losses.items()}, norm


def phase_retina_card_vs_cpu(cfg, model, weights):
    """RetinaNet card against CPU, f32, TF32 off: det_test's first request (one 800x1333 image)
    stage by stage and its detections, then one train forward and backward at batch 2: anchor
    labels, losses, gradient norm."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.data import build_test_dataloader
    from basedet_tpu_torch.ops.iou_kernel import box_iou, box_iou_plain
    from basedet_tpu_torch.utils.compare import match_detections

    cpu = build_model(cfg, "cpu")
    cpu.load_weights(weights)
    request = next(iter(build_test_dataloader(cfg)))
    request = {k: request[k] for k in ("data", "im_info")}
    t0 = time.perf_counter()
    c_stages, c_dets = _retina_stages(cpu, request)
    g_stages, g_dets = _retina_stages(model, request)
    stage_err = {k: float((g_stages[k] - v).abs().max() / v.abs().max()) for k, v in c_stages.items()}
    frac = match_detections(c_dets, g_dets)
    cpu_model, _, _, batch = _retina_train_setup(weights, "cpu")
    plain = box_iou_plain.calls
    c_labels, c_losses, c_norm = _retina_train_pass(cpu_model, batch)
    check(box_iou_plain.calls == plain + 1, "the CPU train pass ran no plain IoU")
    cpu_s = time.perf_counter() - t0
    launches = box_iou.launches
    g_labels, g_losses, g_norm = _retina_train_pass(_retina_train_setup(weights, "cuda")[0], batch)
    check(box_iou.launches == launches + 1, "the card's train pass launched no IoU kernel")
    agree = float((g_labels == c_labels).float().mean())
    rel = {k: abs(g_losses[k] - v) / max(abs(v), 1e-12) for k, v in c_losses.items()}
    norm_rel = abs(g_norm - c_norm) / c_norm
    log(f"[parity] RetinaNet card vs CPU, f32 (CPU runs {cpu_s:.1f} s, plain IoU): one {FRCNN_IMAGE[0]}x"
        f"{FRCNN_IMAGE[1]} image, max |diff| over max |value| per stage: "
        f"{', '.join(f'{k} {v:.3e}' for k, v in stage_err.items())} (tol {HEAD_ATOL}); "
        f"{int(c_dets['valid'].sum())} CPU / {int(g_dets['valid'].sum())} card detections, {frac:.4f} matched "
        f"(label, IoU >= 0.999, |dscore| <= 1e-4); train pass at batch {RETINA_B}: anchor labels agree on "
        f"{agree:.6f} of {c_labels.numel()} (min {LABEL_AGREE}; CPU {int((c_labels > 0).sum())} foreground, "
        f"{int((c_labels == -1).sum())} ignored); losses card {', '.join(f'{k} {v:.6f}' for k, v in g_losses.items())} "
        f"/ CPU {', '.join(f'{k} {v:.6f}' for k, v in c_losses.items())}, worst rel diff {max(rel.values()):.3e} "
        f"(tol {LOSS_RTOL}); gradient norm {g_norm:.6f} card / {c_norm:.6f} CPU, rel diff {norm_rel:.3e} "
        f"(tol {GRAD_NORM_RTOL})")
    check(max(stage_err.values()) <= HEAD_ATOL, f"RetinaNet stages differ between card and CPU: {stage_err}")
    phase_retina_low_quality(cpu_model, model)
    check(np.isfinite(g_dets["boxes"]).all() and g_dets["valid"].any(), "card detections empty or non-finite")
    check(frac >= FRCNN_AGREE, f"only {frac:.3f} of the CPU's RetinaNet detections matched on the card")
    check(agree >= LABEL_AGREE, f"only {agree:.6f} of the anchor labels agree between card and CPU")
    check(all(math.isfinite(v) for v in g_losses.values()), "non-finite RetinaNet losses on the card")
    check(max(rel.values()) <= LOSS_RTOL, f"RetinaNet train losses differ between card and CPU: {rel}")
    check(norm_rel <= GRAD_NORM_RTOL, f"RetinaNet gradient norms differ by {norm_rel:.3e}")


def _small_gts(rng, B, K=100, n=12):
    """(B, K, 5) padded gts whose best anchor IoU lies under the 0.4 background threshold: n valid rows
    per image, alternately 8x8 boxes (each inside several 32x32 and ratio anchors of area 1024 at once,
    so that its best IoU, 64/1024, ties across them) and 400x20 slivers."""
    gt = np.zeros((B, K, 5), np.float32)
    small = np.arange(n) % 2 == 0
    for b in range(B):
        x, y = rng.uniform(20, 900, n), rng.uniform(20, 760, n)
        w, h = np.where(small, 8.0, 400.0), np.where(small, 8.0, 20.0)
        gt[b, :n] = np.stack([x, y, x + w, y + h, rng.randint(1, 81, n)], 1)
    return torch.from_numpy(gt)


def phase_retina_low_quality(cpu_model, model):
    """The anchor assignment (IoU kernel, Matcher, encode) on the card against the CPU's on gts that only
    the low-quality rule can match (the synthetic loader's boxes, 10-40% of the image, always find an
    anchor at IoU >= 0.5): labels equal, offsets within 1e-5, low-quality matches and ties among them
    live."""
    from basedet_tpu_torch.ops.iou_kernel import box_iou_plain

    gts = _small_gts(np.random.RandomState(SEED + 11), RETINA_B)
    num = torch.full((RETINA_B,), 12, dtype=torch.int64)
    anchors = torch.cat(cpu_model.anchors([torch.zeros(1, 1, h, w) for h, w in RETINA_LEVELS]))
    check(anchors.shape[0] == RETINA_ANCHORS, f"{anchors.shape[0]} RetinaNet anchors")
    runs = {}
    for m in (cpu_model, model):
        labels, offsets = m.ground_truth(anchors.to(m.device), gts.to(m.device), num.to(m.device))
        runs[m.device.type] = labels.cpu(), offsets.cpu()
    valid = torch.arange(gts.shape[1])[None] < num[:, None]
    fg, ign, picks, low = low_quality_counts(cpu_model.matcher, box_iou_plain(gts[..., :4], anchors), valid,
                                             runs["cpu"][0])
    same = torch.equal(runs["cuda"][0], runs["cpu"][0])
    off_err = float((runs["cuda"][1] - runs["cpu"][1]).abs().max())
    log(f"[retina] assignment on gts only the low-quality rule matches ({int(num.sum())} valid: 8x8 boxes and "
        f"400x20 slivers): card labels equal to the CPU's {same}, offsets max |diff| {off_err:.3e}; foreground {fg} "
        f"= the rule's picks {picks} (ties included), {low} of them under the 0.5 threshold; ignored {ign}")
    check(same, "the card's anchor labels differ from the CPU's on the low-quality gts")
    check(off_err <= 1e-5, f"the card's anchor offsets differ from the CPU's by {off_err:.3e}")
    check(low > 0 and picks > int(num.sum()), f"low-quality matches {low}, picks {picks}: the rule or its ties are not live")


def phase_retina_train_timing(weights, card):
    """One f32 RetinaNet train step at batch 2 of 800x1333 (input already on the card): backbone +
    FPN, head, the IoU kernel alone, the assignment (IoU + Matcher + encode) and the losses, each
    timed alone on the previous stage's outputs with gradients enabled; get_losses, get_losses with
    backward and the whole step as nested prefixes; peak memory. Returns (step ms, a function
    running one step)."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.ops.iou_kernel import box_iou

    model, state, step, batch = _retina_train_setup(weights, "cuda")
    batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    m, reps = model.module, MODEL_REPS

    def timed(fn):
        def run():
            with full_f32():
                return fn()
        return cuda_ms(run, reps=reps, warmup=2), run()

    x = model.pre_process(batch, train=True)
    num_gt = x["img_info"][:, 4].long()
    t_feat, feats = timed(lambda: m.features(x["image"]))
    t_head, (logits_l, offsets_l) = timed(lambda: m.head(feats))
    anchors = torch.cat(model.anchors(logits_l), dim=0)
    gts = x["gt_boxes"][..., :4].contiguous()
    t_iou = cuda_ms(lambda: box_iou(gts, anchors), reps=reps, warmup=2)
    t_assign, (labels, gt_offsets) = timed(lambda: model.ground_truth(anchors, x["gt_boxes"], num_gt))
    t_losses, _ = timed(lambda: model.losses(*(torch.cat(v, dim=1) for v in model.flatten(logits_l, offsets_l)),
                                              labels, gt_offsets))
    del feats, logits_l, offsets_l

    def losses_backward():
        m.zero_grad(set_to_none=True)
        model.get_losses(batch)[0].backward()

    t_loss, _ = timed(lambda: model.get_losses(batch)[0])
    t_fb, _ = timed(losses_backward)
    torch.cuda.reset_peak_memory_stats()
    t_step = cuda_ms(lambda: step(state, batch), reps=reps, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    log(f"[timing] RetinaNet R50-FPN f32 train step, batch {RETINA_B} of {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]}: "
        f"{t_step:.3f} ms per step ({1000 * RETINA_B / t_step:.2f} img/s); each alone, gradients enabled: "
        f"backbone+FPN {t_feat:.3f}, head {t_head:.3f}, assignment (IoU kernel + Matcher + encode) "
        f"{t_assign:.3f} ms (the IoU kernel alone {t_iou:.4f}), flatten+losses {t_losses:.3f} ms; get_losses "
        f"{t_loss:.3f} ms, backward {t_fb - t_loss:.3f} ms, SGD {t_step - t_fb:.3f} ms (differences of means of "
        f"{reps} runs of nested prefixes); peak memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated), "
        f"input already on the card | {card}")
    return t_step, lambda: step(state, batch)


def phase_retina_timing(model, card):
    """RetinaNet f32 inference at batch 1 and 8 of 800x1333, input on the card: the whole request,
    the network, the per-level top-1000 (sigmoid, stable sort of R·C scores, decode) and NMS with
    the rescale, each timed alone on the previous stage's outputs, means of MODEL_REPS."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.layers.common.post_processing import post_processing

    test_cfg = model.cfg.TEST
    for bs in (1, 8):
        batch = _timing_batch(bs, FRCNN_IMAGE)
        total = cuda_ms(lambda: model.inference(batch), reps=MODEL_REPS, warmup=2)
        torch.cuda.reset_peak_memory_stats()
        model.inference(batch)
        peak = torch.cuda.max_memory_allocated()
        with torch.inference_mode(), full_f32():
            x = model.pre_process(batch)
            image, info = x["image"], x["img_info"]
            t_net = cuda_ms(lambda: model.module(image), reps=MODEL_REPS, warmup=2)
            logits_l, offsets_l = model.module(image)
            flat = model.flatten(logits_l, offsets_l)
            anchors = model.anchors(logits_l)
            t_topk = cuda_ms(lambda: model.candidates(*flat, anchors), reps=MODEL_REPS, warmup=2)
            cands = model.candidates(*flat, anchors)
            t_nms = cuda_ms(lambda: post_processing(*cands, info, test_cfg.IOU_THRESHOLD,
                                                    test_cfg.MAX_BOXES_PER_IMAGE), reps=MODEL_REPS, warmup=2)
        log(f"[timing] RetinaNet R50-FPN f32 {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} batch {bs}: {total:.3f} ms per batch "
            f"({1000 * bs / total:.2f} img/s); network {t_net:.3f}, top-1000 per level + decode {t_topk:.3f}, "
            f"NMS at K = {cands[1].shape[1]} + rescale {t_nms:.3f} ms (each alone, means of {MODEL_REPS}); peak memory "
            f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated), input already on the card | {card}")


# -- the data slice: a COCO-format set on disk, the real loaders, eval and resume ---------------

# the synthetic set of sanity_e2e at YOLOX-S's input size; 96 train images cover an epoch of DATA_STEPS
# batches of 8 (the smoke's whole run has to fit its time limit)
DATA_SIZE, DATA_TRAIN, DATA_VAL = 640, 96, 16
DATA_STEPS = 10  # iterations per epoch of phases 25-26
DATA_COUNTS = {}  # data-slice path -> {kernel: (launches, plain calls)}


class _Bf16Launches:
    """A kernel's bf16 variant as ``kernel_counts`` reads a kernel: its wrapper counts its launches in
    ``launches_bf16``."""

    def __init__(self, wrapper):
        self.wrapper = wrapper

    @property
    def launches(self):
        return self.wrapper.launches_bf16

    @launches.setter
    def launches(self, value):
        self.wrapper.launches_bf16 = value


@contextlib.contextmanager
def kernel_counts(path):
    """Zero every kernel's launch count and every plain version's call count just before the body
    (one main path's run) and keep both, read just after, under ``path``: {kernel: (launches,
    plain calls)}. The IoU's go to IOU_COUNTS too."""
    from basedet_tpu_torch.ops.fused_bn import fused_gemm_stats_backward_plain, fused_gemm_stats_plain
    from basedet_tpu_torch.ops.fused_bn_kernel import fused_gemm_stats, fused_gemm_stats_backward
    from basedet_tpu_torch.ops.matching_kernel import dynamic_k_matching, dynamic_k_matching_plain
    from basedet_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain
    from basedet_tpu_torch.ops.roi_align import multilevel_roi_align_backward_plain, multilevel_roi_align_plain
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align, multilevel_roi_align_backward
    from basedet_tpu_torch.ops.scatter_rows import scatter_rows_plain, segment_rows_plain
    from basedet_tpu_torch.ops.scatter_rows_kernel import scatter_rows, segment_rows

    pairs = {"nms_keep": (nms_keep, nms_keep_plain), "dynamic_k_matching": (dynamic_k_matching, dynamic_k_matching_plain),
             "multilevel_roi_align": (multilevel_roi_align, multilevel_roi_align_plain),
             "multilevel_roi_align_backward": (multilevel_roi_align_backward, multilevel_roi_align_backward_plain),
             "multilevel_roi_align_bf16": (_Bf16Launches(multilevel_roi_align), multilevel_roi_align_plain),
             "multilevel_roi_align_backward_bf16": (_Bf16Launches(multilevel_roi_align_backward),
                                                    multilevel_roi_align_backward_plain),
             "fused_gemm_stats": (fused_gemm_stats, fused_gemm_stats_plain),
             "fused_gemm_stats_backward": (fused_gemm_stats_backward, fused_gemm_stats_backward_plain),
             "scatter_rows": (scatter_rows, scatter_rows_plain),
             "segment_rows": (segment_rows, segment_rows_plain)}
    for kernel, plain in pairs.values():
        kernel.launches, plain.calls = 0, 0
    with iou_counted(path):
        yield
    DATA_COUNTS[path] = {name: (kernel.launches, plain.calls) for name, (kernel, plain) in pairs.items()}
    DATA_COUNTS[path]["box_iou"] = IOU_COUNTS[path]


def check_counts(path, expected):
    """Each kernel launched as ``expected`` says (0 where it does not say; #9's segmentation as often as
    #9) on ``path``, every plain version never."""
    expected = {**expected, "segment_rows": expected.get("scatter_rows", 0)}
    counts = DATA_COUNTS[path]
    for name, (launches, plain) in counts.items():
        check(launches == expected.get(name, 0), f"{path}: {name} launched {launches} times, not "
                                                 f"{expected.get(name, 0)}")
        check(plain == 0, f"{path}: the plain {name} ran {plain} times on the main path")
    return ", ".join(f"{name} {launches}" for name, (launches, _) in counts.items() if launches) + ", plain 0"


def phase_data_set(out_dir):
    """24. The synthetic COCO set of ``sanity_e2e`` at 640x640, DATA_TRAIN train and DATA_VAL val
    images written as PNG by the port, registered for the phases below."""
    from basedet_tpu_torch.data import register_dataset
    from basedet_tpu_torch.tools.sanity_e2e import make_synthetic_coco

    try:
        import PIL  # noqa: F401  (only JPEG would need it)
        pil = f"Pillow {PIL.__version__} importable"
    except ImportError:
        pil = "no Pillow"
    t0 = time.perf_counter()
    train, val = make_synthetic_coco(os.path.join(out_dir, "synth"), n_train=DATA_TRAIN, n_val=DATA_VAL,
                                     size=DATA_SIZE)
    register_dataset("smoke_synth_train", *train)
    register_dataset("smoke_synth_val", *val)
    log(f"[data] synthetic COCO set, {DATA_TRAIN} train + {DATA_VAL} val PNGs of {DATA_SIZE}x{DATA_SIZE} "
        f"(3 classes, 1-3 boxes each) written in {time.perf_counter() - t0:.2f} s; os.cpu_count() "
        f"{os.cpu_count()}; {pil}")


def _data_opts(out_dir, epochs, workers):
    return ["DATA.TRAIN.name", "smoke_synth_train", "DATA.TEST.name", "smoke_synth_val", "DATA.NUM_CLASSES", "3",
            "DATA.NUM_WORKERS", str(workers), "MODEL.BATCHSIZE", "8", "SOLVER.MAX_EPOCH", str(epochs),
            "SOLVER.NUM_IMAGE_PER_EPOCH", str(8 * DATA_STEPS), "AUG.TRAIN_SETTING.NO_AUG_EPOCH", "1",
            "GLOBAL.LOG_INTERVAL", "1", "GLOBAL.OUTPUT_DIR", out_dir,
            "GLOBAL.CKPT_SAVE_DIR", os.path.join(out_dir, "data_ckpt")]


@contextlib.contextmanager
def step_records():
    """Per call of DetTrainer.train_one_iter: (host seconds of the call, its data_time, its step,
    the epoch); with GLOBAL.LOG_INTERVAL 1 each call ends by reading the losses, so a call is one
    step's wall time."""
    from basedet_tpu_torch.engine.trainer import DetTrainer

    fn, records = DetTrainer.train_one_iter, []

    def wrapper(self, data_iter):
        t0 = time.perf_counter()
        fn(self, data_iter)
        records.append((time.perf_counter() - t0, self.meters["data_time"].latest, self.state.step,
                        self.progress.epoch))

    DetTrainer.train_one_iter = wrapper
    try:
        yield records
    finally:
        DetTrainer.train_one_iter = fn


def _step_summary(records):
    wall = sorted(r[0] for r in records)
    data = sorted(r[1] for r in records)
    return (f"median data_time {1000 * data[len(data) // 2]:.1f} ms (range {1000 * data[0]:.1f}-"
            f"{1000 * data[-1]:.1f}), median step {1000 * wall[len(wall) // 2]:.1f} ms wall with the losses "
            f"read each step (range {1000 * wall[0]:.1f}-{1000 * wall[-1]:.1f})")


def phase_data_train(out_dir, card):
    """25. det_train on full-width YOLOX-S (3 classes, random init) over the synthetic set: mosaic
    and mixup live in min(8, cores) DataLoader workers, batches of 8 (640x640, then the multiscale
    resize), 2 epochs of 10 steps, the second without augmentation; EvalHook on the DATA_VAL val images
    with the live and the EMA weights. Per step the matching and IoU kernels once; NMS once per val
    request; plain versions never. Returns the trainer."""
    from basedet_tpu_torch.tools import det_train

    workers = min(8, os.cpu_count() or 1)
    with step_records() as records, kernel_counts("YOLOX-S det_train, synthetic set"):
        t0 = time.perf_counter()
        trainer = det_train.main(["-f", CONFIG, "--device", "cuda", *_data_opts(out_dir, 2, workers)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    steps = trainer.state.step
    loader, mosaic = trainer.dataloader, trainer.dataloader.mosaic_dataset
    check(steps == 2 * DATA_STEPS, f"det_train on the synthetic set took {steps} steps, not {2 * DATA_STEPS}")
    counts = check_counts("YOLOX-S det_train, synthetic set", {
        "dynamic_k_matching": steps, "box_iou": steps, "nms_keep": 2 * DATA_VAL})
    check(trainer.model.use_l1 and not mosaic.enable_mosaic and not mosaic.enable_mixup,
          "the no-aug switch did not turn L1 on and mosaic and mixup off")
    check(loader.forks == (2 if workers else 0), f"the workers were forked {loader.forks} times, not twice")
    results = trainer.eval_results
    check(set(results) == {"model", "EMA"} and all("AP" in r and "AP50" in r for r in results.values()),
          f"EvalHook gave {results}")
    sizes = sorted({trainer.model.target_size_for_step(s)[0] for s in range(1, steps + 1)})
    log(f"[data-train] det_train YOLOX-S on the synthetic set, {steps} steps of 8 (mosaic + mixup epoch 1, "
        f"no-aug epoch 2; multiscale sizes {sizes}), {workers} DataLoader workers (forked {loader.forks} "
        f"times: at the start and at the no-aug switch), in {seconds:.2f} s with the eval; kernel launches "
        f"{counts}; {_step_summary(records)}; EvalHook on {DATA_VAL} val requests: live AP "
        f"{results['model']['AP']:.4f}, EMA AP {results['EMA']['AP']:.4f} (random init) | {card}")
    return trainer


def phase_data_resume(out_dir, card):
    """26. det_train --resume into the same directory with MAX_EPOCH 3: it restores latest.pt (step
    20, epoch 2) and trains epoch 3 only, without augmentation; then EvalHook again."""
    from basedet_tpu_torch.engine.hooks import ResumeHook
    from basedet_tpu_torch.tools import det_train

    keep = lambda args, out: (args[0].trainer.state.step, args[0].trainer.progress.epoch)
    workers = min(8, os.cpu_count() or 1)
    with recording(ResumeHook, "before_train", keep) as restored, \
            kernel_counts("YOLOX-S det_train --resume, synthetic set"):
        trainer = det_train.main(["-f", CONFIG, "--device", "cuda", "--resume", *_data_opts(out_dir, 3, workers)])
    check(restored == [(2 * DATA_STEPS, 3)], f"the resume restored (step, epoch) {restored}, not "
                                             f"[({2 * DATA_STEPS}, 3)]")
    check(trainer.state.step == 3 * DATA_STEPS, f"the resumed run ended at step {trainer.state.step}")
    counts = check_counts("YOLOX-S det_train --resume, synthetic set", {
        "dynamic_k_matching": DATA_STEPS, "box_iou": DATA_STEPS, "nms_keep": 2 * DATA_VAL})
    log(f"[data-resume] det_train --resume, MAX_EPOCH 3: restored step {restored[0][0]}, started at epoch "
        f"{restored[0][1]}, ended at step {trainer.state.step}; kernel launches {counts}; EMA AP "
        f"{trainer.eval_results['EMA']['AP']:.4f} | {card}")


def phase_data_other_models(out_dir, frcnn_weights, cnet_weights, card):
    """27. Two steps each of Faster R-CNN (ShortestEdgeResize 640-800 and flip, batch 2) and CenterNet
    (CenterAffine to 512x512, flip and the colour jitters, batch 16) over the synthetic set through
    DataloaderBuilder and its AUG.TRAIN_VALUE: kernel counts per step as in phases 11 and 14."""
    from basedet_tpu_torch.tools import det_train

    workers = str(min(8, os.cpu_count() or 1))
    runs = (("Faster R-CNN", FRCNN_CONFIG, frcnn_weights, FRCNN_TRAIN_B,
             {"multilevel_roi_align": 2, "multilevel_roi_align_backward": 2, "nms_keep": 2, "box_iou": 4}),
            ("CenterNet", CNET_CONFIG, cnet_weights, CNET_B, {"scatter_rows": 6}))
    for name, config, weights, batch, expected in runs:
        path = f"{name} det_train, synthetic set"
        opts = ["DATA.TRAIN.name", "smoke_synth_train", "DATA.TEST.name", "dummy", "DATA.NUM_WORKERS", workers,
                "MODEL.BATCHSIZE", str(batch), "MODEL.WEIGHTS", weights, "SOLVER.MAX_EPOCH", "1",
                "SOLVER.NUM_IMAGE_PER_EPOCH", str(2 * batch), "GLOBAL.LOG_INTERVAL", "1", "GLOBAL.OUTPUT_DIR",
                out_dir, "GLOBAL.CKPT_SAVE_DIR", os.path.join(out_dir, f"data_{name[:4].lower()}_ckpt")]
        with step_records() as records, kernel_counts(path):
            trainer = det_train.main(["-f", config, "--device", "cuda", *opts])
        check(trainer.state.step == 2, f"{path} took {trainer.state.step} steps, not 2")
        counts = check_counts(path, expected)
        check(math.isfinite(trainer.meters["total_loss"].latest), f"{path}: non-finite loss")
        log(f"[data-{name[:4].lower()}] {path}: 2 steps of {batch} through DataloaderBuilder "
            f"({', '.join(t[0] for t in trainer.cfg.AUG.TRAIN_VALUE)}), {workers} workers; kernel launches "
            f"{counts}; {_step_summary(records)} | {card}")


def _loop_timing(out_dir, workers, dummy, steps=12, warmup=3):
    """YOLOX-S f32 train steps at batch 8 through DetTrainer.train_one_iter with the losses read
    every ``steps`` steps only (the host runs ahead), from the real loader over the synthetic set
    or from DummyLoader: (ms per step, idle share of the device over the timed steps, the median
    data_time)."""
    from torch.profiler import ProfilerActivity

    from basedet_tpu_torch import build_trainer
    from basedet_tpu_torch.tools import import_config

    cfg = import_config(CONFIG)
    cfg.merge(_data_opts(out_dir, 1, workers) + ["GLOBAL.LOG_INTERVAL", str(steps), "SOLVER.NUM_IMAGE_PER_EPOCH",
                                                 str(8 * (steps + warmup)), "DATA.TEST.name", "dummy"])
    if dummy:
        cfg.merge(["DATA.TRAIN.name", "dummy"])
    trainer = build_trainer(cfg, "cuda")
    trainer.init_state()
    trainer.model.train()
    data_iter = iter(trainer.dataloader)
    try:
        for i in range(warmup):
            trainer.progress.inner_iter = i + 1
            trainer.train_one_iter(data_iter)
        torch.cuda.synchronize()
        times = []
        with padded_profile([ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                trainer.progress.inner_iter = warmup + i + 1
                trainer.train_one_iter(data_iter)
                times.append(trainer.meters["data_time"].latest)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1000 / steps
    finally:
        getattr(trainer.dataloader, "close", lambda: None)()
    averages = prof.key_averages()
    key = "self_device_time_total" if len(averages) and hasattr(averages[0], "self_device_time_total") \
        else "self_cuda_time_total"
    busy = sum(getattr(e, key) for e in averages if e.device_type == torch.autograd.DeviceType.CUDA) / 1000 / steps
    check(busy > 0, "the profiler saw no device time in the loop timing")
    times.sort()
    return wall, 1 - busy / wall, 1000 * times[len(times) // 2]


def phase_data_bench(out_dir, card):
    """28. tools/bench_pipeline at 0 and 8 workers (the real YOLOX loader at 640x640, batches of
    8), the serial split of one batch and one batch's copy to the card from pinned and from pageable
    memory; then YOLOX-S f32 train steps fed by the real loader against DummyLoader's, with the
    device's idle share (profiler, profiled wall)."""
    from basedet_tpu_torch.tools import bench_pipeline

    workers = [w for w in (0, 8) if w <= (os.cpu_count() or 1)]
    t0 = time.perf_counter()
    results = bench_pipeline.main(["--workers", *map(str, workers), "--size", str(DATA_SIZE), "--batch-size", "8",
                                   "--batches", "8", "--images", str(DATA_TRAIN), "--device", "cuda",
                                   "--out", os.path.join(out_dir, "pipe_bench")])
    by = {r["bench"]: r for r in results}
    rates = ", ".join(f"{r['workers']} workers {r['images_per_sec']:.1f} img/s ({r['ms_per_batch']:.1f} ms a batch)"
                      for r in results if r["bench"] == "loader")
    split, copy = by["split"], by["copy"]
    log(f"[data-bench] bench_pipeline, YOLOX loader 640x640, batches of 8, {os.cpu_count()} cores, in "
        f"{time.perf_counter() - t0:.1f} s: {rates}; serial batch: samples {split['ms_samples']:.1f} ms, pack "
        f"{split['ms_pack']:.2f} ms ({100 * split['pack_share']:.2f}% of the batch's host time), pinning "
        f"{split['ms_pin']:.2f} ms; one batch's images ({copy['bytes']} B) to the card: pinned non_blocking "
        f"{copy['pinned_ms']:.3f} ms ({copy['pinned_gb_per_s']:.1f} GB/s), pageable {copy['pageable_ms']:.3f} ms "
        f"(CUDA events, means of 20) | {card}")
    n = min(8, os.cpu_count() or 1)
    real = _loop_timing(out_dir, n, dummy=False)
    dummy = _loop_timing(out_dir, n, dummy=True)
    log(f"[data-bench] YOLOX-S f32 train steps at batch 8 (multiscale), losses read once per 12 steps, "
        + "; ".join(f"{label}: {ms:.1f} ms a step, device idle share {idle:.3f}, median data_time {dt:.1f} ms"
                    for label, (ms, idle, dt) in (("real loader", real), ("DummyLoader", dummy)))
        + f" (profiled wall, {n} workers) | {card}")


# -- the FCOS family (FCOS, ATSS, OTA) and FreeAnchor: det_train and det_test at full width ------

NEW_MODELS = {  # model: (the port's config, {kernel: launches per det_train step})
    "FCOS": ("basedet_tpu_torch/playground/fcos_r50_1x/config.py", {}),
    "ATSS": ("basedet_tpu_torch/playground/atss_r50_1x/config.py", {"box_iou": 1}),
    "OTA": ("basedet_tpu_torch/playground/ota_r50_1x/config.py", {"dynamic_k_matching": 1}),
    "FreeAnchor": ("basedet_tpu_torch/playground/freeanchor_r50_1x/config.py", {"box_iou": 2}),
}
NEW_B, NEW_STEPS, NEW_REQUESTS, NEW_REPS = 2, 2, 8, 5  # batch, det_train steps, DummyLoader's det_test requests, reps
POINTS = sum(h * w for h, w in RETINA_LEVELS)  # 22,400 points at 800x1344, OTA's matching M


@torch.no_grad()
def randomise_new(name, module, generator):
    """FreeAnchor: as ``randomise_retina``. The point head's models: the frozen BN statistics and
    affine, the GroupNorm affine and every bias drawn from generator as ``randomise_retina`` draws
    them, the class biases spread by 2 around the prior, and the box biases raised by 2, so that an
    offset spans about 2 strides (relu(raw · scale) · stride) and same-class neighbours overlap:
    NMS then suppresses, and the scores clear the 0.05 threshold."""
    from basedet_tpu_torch.layers.common.blocks import FrozenBatchNorm

    if name == "FreeAnchor":
        return randomise_retina(module, generator)
    for m in module.modules():
        if isinstance(m, FrozenBatchNorm):
            m.running_mean.normal_(0.0, 0.2, generator=generator)
            m.running_var.uniform_(0.5, 2.0, generator=generator)
        if isinstance(m, (FrozenBatchNorm, torch.nn.GroupNorm)):
            m.weight.uniform_(0.5, 1.5, generator=generator)
        if getattr(m, "bias", None) is not None:
            m.bias.add_(torch.empty_like(m.bias).normal_(0.0, 0.3, generator=generator))
    head = module.head
    head.cls_score.bias.add_(torch.empty_like(head.cls_score.bias).normal_(0.0, 2.0, generator=generator))
    head.bbox_pred.bias.add_(2.0)


def _new_counts(path, expected):
    """``check_counts``, its text beginning with "none" where no kernel launched."""
    counts = check_counts(path, expected)
    return "none" + counts if counts.startswith(",") else counts


def _new_opts(out_dir):
    return ["DATA.TEST.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", str(FRCNN_IMAGE).replace(" ", ""),
            "GLOBAL.OUTPUT_DIR", out_dir]


def _new_train_opts(out_dir, name, weights):
    return ["DATA.TRAIN.name", "dummy", "DATA.TEST.name", "dummy", "DATA.DUMMY_IMAGE_SIZE",
            str(FRCNN_IMAGE).replace(" ", ""), "MODEL.BATCHSIZE", str(NEW_B), "SOLVER.MAX_EPOCH", "1",
            "SOLVER.NUM_IMAGE_PER_EPOCH", str(NEW_STEPS * NEW_B), "GLOBAL.LOG_INTERVAL", "1", "MODEL.WEIGHTS",
            weights, "GLOBAL.OUTPUT_DIR", out_dir, "GLOBAL.CKPT_SAVE_DIR", os.path.join(out_dir, f"{name}_ckpt")]


def make_new_weights(out_dir, name):
    """Full-width ``name`` on the card with random weights from SEED, spread by ``randomise_new``,
    saved as a state_dict. Returns (cfg for det_test, model, path)."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.tools import import_config

    cfg = import_config(NEW_MODELS[name][0])
    cfg.merge(_new_opts(out_dir))
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    model = build_model(cfg, "cuda", generator)
    randomise_new(name, model.module, generator)
    weights = os.path.join(out_dir, f"{name.lower()}_r50_seed0.pt")
    torch.save(model.module.state_dict(), weights)
    m = cfg.MODEL
    log(f"[{name.lower()}] {NEW_MODELS[name][0]}: {m.BACKBONE.NAME} (FrozenBN, freeze_at {m.BACKBONE.FREEZE_AT}), "
        f"FPN P3-P7 {m.FPN.OUT_CHANNELS}, {m.HEAD.NUM_CONVS}-conv head"
        f"{' with GroupNorm(32)' if m.HEAD.get('WITH_NORM', name != 'FreeAnchor') else ''}, "
        f"{cfg.DATA.NUM_CLASSES} classes, {sum(p.numel() for p in model.module.parameters())} parameters, "
        f"random from seed {SEED}")
    return cfg, model, weights


def make_backbone_pickle(out_dir):
    """``utils/reference_layout.py``'s backbone-only R50 in the ImageNet naming (MegEngine BN
    shapes, the ``fc`` classifier), pickled, its values drawn from a seed at sensible scales:
    convolutions lecun-normal, BN statistics and affine as ``randomise_retina`` draws them."""
    import pickle

    from basedet_tpu_torch.utils.reference_layout import reference_r50_backbone_state

    rng = np.random.RandomState(SEED + 20)

    def fill(name, shape):
        if name.endswith("running_mean"):
            return rng.normal(0.0, 0.2, shape)
        if name.endswith("running_var"):
            return rng.uniform(0.5, 2.0, shape)
        if shape[0] == 1:  # a BN's (1, C, 1, 1) weight or bias
            return rng.uniform(0.5, 1.5, shape) if name.endswith("weight") else rng.normal(0.0, 0.3, shape)
        return rng.normal(0.0, math.sqrt(1.0 / int(np.prod(shape[1:]))), shape)

    state = reference_r50_backbone_state(fill)
    path = os.path.join(out_dir, "r50_backbone_reference_layout.pkl")
    with open(path, "wb") as f:
        pickle.dump(state, f)
    return state, path


def phase_new_train(out_dir, name, weights, backbone=None):
    """det_train on full-width ``name``, NEW_STEPS steps of NEW_B images of 800x1333, every kernel's
    and plain version's count zeroed just before and read just after. ATSS and FreeAnchor keep their
    IoU calls' arguments, OTA its matching calls'. With ``backbone`` (the pickle of
    ``make_backbone_pickle`` and its state), MODEL.WEIGHTS is that file: the matcher must load the
    trunk (its frozen BN buffers and stem are checked after the run) and leave the FPN and head at
    their init. Returns (the kernels' calls, the dumped weights)."""
    from basedet_tpu_torch.layers.common import matcher
    from basedet_tpu_torch.models import det
    from basedet_tpu_torch.models.base_net import BaseNet
    from basedet_tpu_torch.models.det import atss, free_anchor
    from basedet_tpu_torch.tools import det_train

    config, per_step = NEW_MODELS[name]
    path = f"{name} det_train"
    owner, attr = {"ATSS": (atss, "box_iou"), "FreeAnchor": (free_anchor, "box_iou"),
                   "OTA": (matcher, "dynamic_k_matching")}.get(name, (None, None))
    keep_args = lambda args, out: tuple(a.clone() if torch.is_tensor(a) else a for a in args)
    keep_losses = lambda args, out: {k: float(v.detach()) for k, v in out[1].items()}
    with (recording(owner, attr, keep_args) if owner else contextlib.nullcontext([])) as calls, \
            recording(getattr(det, name), "get_losses", keep_losses) as losses, \
            recording(BaseNet, "load_weights", lambda args, out: out) as loads, kernel_counts(path):
        t0 = time.perf_counter()
        trainer = det_train.main(["-f", config, "--device", "cuda",
                                  *_new_train_opts(out_dir, name, backbone[1] if backbone else weights)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    steps = trainer.state.step
    check(steps == NEW_STEPS and len(losses) == NEW_STEPS, f"{name} det_train took {steps} steps, not {NEW_STEPS}")
    counts = _new_counts(path, {k: n * steps for k, n in per_step.items()})
    check(len(calls) == sum(per_step.values()) * steps, f"{name}: {len(calls)} recorded kernel calls")
    check(all(math.isfinite(v) for step in losses for v in step.values()), f"non-finite {name} losses {losses}")
    check(all(step["total_loss"] > 0 for step in losses), f"{name} losses {losses}")
    ckpt = os.path.join(out_dir, f"{name}_ckpt")
    for f in ("latest.pt", "epoch_1.pt", "dumped_model.pt"):
        check(os.path.exists(os.path.join(ckpt, f)), f"{name} det_train wrote no {f}")
    loaded = ""
    if backbone:
        state, _ = backbone
        (stats,) = loads
        module = trainer.model.module
        keys = list(module.state_dict())
        trunk = sum(k.startswith("bottom_up.") for k in keys)
        check(stats["matched"] == trunk and stats["unused"] == ["fc.weight", "fc.bias"]
              and sorted(stats["missing"]) == sorted(k for k in keys if not k.startswith("bottom_up.")),
              f"the backbone-only checkpoint loaded as {stats['matched']} matched, {len(stats['missing'])} missing, "
              f"unused {stats['unused']}")
        frozen = {"bottom_up.conv1.weight": "conv1.weight",  # frozen (FREEZE_AT 2): SGD leaves it
                  **{f"bottom_up.FrozenBatchNorm_0.{f}": f"bn1.{f}" for f in ("weight", "bias", "running_mean",
                                                                               "running_var")},
                  **{f"bottom_up.layer4_2.FrozenBatchNorm_2.{f}": f"layer4.2.bn3.{f}" for f in ("weight",
                                                                                            "running_var")}}
        sd = module.state_dict()
        for k, ref in frozen.items():
            check(torch.equal(sd[k].cpu(), torch.from_numpy(state[ref]).reshape(sd[k].shape)),
                  f"{k} is not the checkpoint's {ref}")
        loaded = (f"; MODEL.WEIGHTS the backbone-only reference-layout R50 pickle: {stats['matched']} matched (the "
                  f"trunk), {len(stats['missing'])} missing (FPN and head, left at their init), unused "
                  f"{stats['unused']}; the stem and frozen BN buffers equal the file's after the run")
    per = "; ".join(", ".join(f"{k.replace('_loss', '')} {v:.4f}" for k, v in step.items()) for step in losses)
    shapes = ", ".join(" x ".join(str(tuple(a.shape)) for a in c[:2]) for c in calls[:sum(per_step.values())])
    log(f"[{name.lower()}-train] det_train {name} R50-FPN, {steps} steps of {NEW_B} images {FRCNN_IMAGE[0]}x"
        f"{FRCNN_IMAGE[1]} (padded 800x1344), f32, in {seconds:.2f} s; kernel launches {counts}"
        f"{f' (first step at {shapes})' if shapes else ''}; losses per step: {per}{loaded}")
    return calls, os.path.join(ckpt, "dumped_model.pt")


def _iou_timing(name, b1, b2, card):
    """Kernel #10 on one case, logged: device time (profiler), events, the plain version's events,
    the bound."""
    from basedet_tpu_torch.ops.iou_kernel import box_iou, box_iou_plain

    call = lambda: box_iou(b1, b2)
    ms, device = cuda_ms(call, reps=20, warmup=3), _iou_device_ms(call)
    plain_ms = cuda_ms(lambda: box_iou_plain(b1, b2), reps=5, warmup=1)
    bound_ms, bound_by = iou_bound(b1, b2)
    log(f"[iou] {name} {tuple(b1.shape)} x {tuple(b2.shape)}: kernel device {device:.4f} ms (profiler), events "
        f"{ms:.4f} ms; plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), device time at "
        f"{bound_ms / device:.2f} of it | {card}")


def phase_new_kernels(name, calls, card):
    """The kernel of ``name``'s det_train against its plain version on the first step's own
    arguments, two runs equal, and timed: OTA's matching (exactly; M = 22,400, past the staged
    row, so streamed), ATSS's and FreeAnchor's IoUs (bit for bit)."""
    from basedet_tpu_torch.ops.iou_kernel import box_iou
    from basedet_tpu_torch.ops.matching_kernel import MAX_STAGED, MAX_TOPK, dynamic_k_matching

    if name == "OTA":
        cost, ious, valid, k = calls[0]
        check(tuple(cost.shape) == (NEW_B, 100, POINTS) and POINTS > MAX_STAGED and k == MAX_TOPK,
              f"OTA's matching took {tuple(cost.shape)}, k {k}: not the streamed full-width call")
        check(bool(((cost > 5e8) == ~valid[..., None]).all()) and bool((cost[valid] > 5e5).any()),
              "the step's cost carries no 1e6/1e9 penalties")
        _check_matching("OTA step 1", cost, ious, valid)
        again = [dynamic_k_matching(cost, ious, valid, k) for _ in range(2)]
        check(all(torch.equal(a, b) for a, b in zip(*again)), "two runs of the matching kernel differ on OTA's step")
        case = f"OTA det_train step 1 ({NEW_B}, 100, {POINTS}), streamed"
        matching_timing([(case, *(a.cpu().numpy() for a in (cost, ious, valid)))], card)
        log(f"[match] OTA step 1: the kernel equal to the plain version and two runs equal, "
            f"{int(valid.sum())} valid gts, {int(again[0][1].sum())} foreground points")
        return
    per_step = NEW_MODELS[name][1]["box_iou"]
    for i, (b1, b2) in enumerate(calls[:per_step]):
        err, bits = check_iou_case(b1, b2)
        repeat = torch.equal(box_iou(b1, b2).view(torch.int32), box_iou(b1, b2).view(torch.int32))
        form = "per image" if b2.dim() == 3 else "shared"
        log(f"[iou] {name} step 1 call {i + 1} ({form}): {tuple(b1.shape)} x {tuple(b2.shape)}: max |kernel - plain| "
            f"{err:.3e}, bit-equal {bits}, two runs bit-equal {repeat}")
        check(bits and repeat, f"the IoU kernel on {name}'s call {i + 1}: bit-equal {bits}, repeat {repeat}")
        _iou_timing(f"{name} call {i + 1} ({form})", b1, b2, card)


def phase_new_slice(out_dir, name, weights):
    """det_test on full-width ``name`` over NEW_REQUESTS requests of one 800x1333 image, the counts
    zeroed just before and read just after: the port's own weights load by matching with nothing
    missing or unused, NMS once a request at K = 5000, suppressing, every other kernel and every
    plain version 0 times."""
    from basedet_tpu_torch.models.base_net import BaseNet
    from basedet_tpu_torch.ops import nms as nms_ops
    from basedet_tpu_torch.tools import det_test

    path = f"{name} det_test"
    seen = lambda args, keep: (args[0].shape[1], list(zip(args[1].sum(1).tolist(), keep.sum(1).tolist())))
    t0 = time.perf_counter()
    with recording(nms_ops, "nms_keep", seen) as calls, recording(BaseNet, "load_weights", lambda a, out: out) \
            as loads, kernel_counts(path):
        results = det_test.main(["-f", NEW_MODELS[name][0], "-w", weights, "--device", "cuda", *_new_opts(out_dir)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(len(loads) == 1 and loads[0]["matched"] > 0 and loads[0]["missing"] == [] == loads[0]["unused"],
          f"{name} det_test loaded {os.path.basename(weights)} as {loads}")
    counts = _new_counts(path, {"nms_keep": NEW_REQUESTS})
    with open(os.path.join(out_dir, "predict_coco.json")) as f:
        records = json.load(f)
    check(np.isfinite([r["bbox"] + [r["score"]] for r in records]).all(), f"non-finite {name} detections")
    check({r["image_id"] for r in records} == set(range(NEW_REQUESTS)), f"not every {name} request was answered")
    check(all(k == RETINA_FINAL_K for k, _ in calls), f"{name}'s NMS took {[k for k, _ in calls]} candidates")
    check(any(k < v for _, call in calls for v, k in call), f"{name}'s NMS suppressed nothing on the main path")
    log(f"[{name.lower()}] det_test {name} R50-FPN with {os.path.basename(weights)} on {NEW_REQUESTS} requests of "
        f"{FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} (weights by matching: {loads[0]['matched']} matched, 0 missing, 0 "
        f"unused): {results}, {len(records)} finite detections in {seconds:.2f} s; "
        f"kernel launches {counts}, NMS at K = {RETINA_FINAL_K}; NMS kept per image {_kept_range([c for _, c in calls])}")


def _new_train_setup(name, weights, device, extra=()):
    """Full-width ``name`` in train mode with ``weights``, its train state and step, and the first
    synthetic batch of NEW_B images of 800x1333."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.data import DataloaderBuilder
    from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
    from basedet_tpu_torch.solver import DetSolver
    from basedet_tpu_torch.tools import import_config

    cfg = import_config(NEW_MODELS[name][0])
    cfg.merge([*_new_train_opts(".", name, weights), *extra])
    model = build_model(cfg, device)
    model.load_weights(weights)
    solver = DetSolver.build(cfg)
    state = TrainState(model.train(), solver)
    return model, state, make_train_step(model, solver, cfg), next(DataloaderBuilder.build(cfg))


def phase_ota_sinkhorn(weights):
    """One OTA train step on the card with MATCHING "sinkhorn" (plain PyTorch, no kernel): finite
    losses, every kernel's count 0."""
    path = "OTA sinkhorn train step"
    model, state, step, batch = _new_train_setup("OTA", weights, "cuda", ["MODEL.MATCHING", "sinkhorn"])
    check(model.matching == "sinkhorn", "MODEL.MATCHING did not reach the model")
    with kernel_counts(path):
        losses = {k: float(v) for k, v in step(state, batch).items()}
        torch.cuda.synchronize()
    counts = _new_counts(path, {})
    check(all(math.isfinite(v) for v in losses.values()) and losses["total_loss"] > 0, f"Sinkhorn losses {losses}")
    log(f"[ota] one train step with MATCHING sinkhorn on the card, batch {NEW_B} of {FRCNN_IMAGE[0]}x"
        f"{FRCNN_IMAGE[1]}: {', '.join(f'{k} {v:.4f}' for k, v in losses.items())}; kernel launches {counts}")


def _fcos_train_pass(model, batch):
    """One FCOS train forward and backward at full width: point labels, losses, gradient norm, on
    the CPU."""
    from basedet_tpu_torch.layers.common.function import full_f32

    model.train()
    with full_f32():
        x = model.pre_process(batch, train=True)
        head_out = model.module(x["image"])
        labels, gt_offsets, gt_ctr = model.ground_truth(model.points(head_out[0]), x["gt_boxes"],
                                                        x["img_info"][:, 4].long())
        losses = model.losses(*(torch.cat(v, dim=1) for v in model.flatten(*head_out)), labels, gt_offsets, gt_ctr)
        model.module.zero_grad(set_to_none=True)
        losses["total_loss"].backward()
    norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in model.module.parameters()
                                if p.grad is not None)))
    return labels.cpu(), {k: float(v.detach()) for k, v in losses.items()}, norm


def phase_fcos_card_vs_cpu(cfg, model, weights):
    """FCOS card against CPU, f32, TF32 off, on the same weights: det_test's first request, the head
    outputs per level (max |diff| over max |value| within HEAD_ATOL) and the detections (at least
    FRCNN_AGREE matched); then one train forward and backward at batch NEW_B on the same batch: the
    points' labels (LABEL_AGREE), losses (LOSS_RTOL) and gradient norm (GRAD_NORM_RTOL)."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.data import build_test_dataloader
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.utils.compare import match_detections

    cpu = build_model(cfg, "cpu")
    cpu.load_weights(weights)
    request = next(iter(build_test_dataloader(cfg)))
    request = {k: request[k] for k in ("data", "im_info")}
    t0 = time.perf_counter()
    heads, dets = [], []
    for m in (cpu, model):
        with torch.inference_mode(), full_f32():
            out = m.module.eval()(m.pre_process(request)["image"])
        heads.append({f"{kind} p{lv + 3}": x.cpu() for kind, xs in zip(("logits", "offsets", "ctrness"), out)
                      for lv, x in enumerate(xs)})
        dets.append({k: v.cpu().numpy() for k, v in m.inference(request).items()})
    head_err = {k: float((heads[1][k] - v).abs().max() / v.abs().max()) for k, v in heads[0].items()}
    frac = match_detections(dets[0], dets[1])
    cpu_model, _, _, batch = _new_train_setup("FCOS", weights, "cpu")
    c_labels, c_losses, c_norm = _fcos_train_pass(cpu_model, batch)
    cpu_s = time.perf_counter() - t0
    g_labels, g_losses, g_norm = _fcos_train_pass(_new_train_setup("FCOS", weights, "cuda")[0], batch)
    agree = float((g_labels == c_labels).float().mean())
    rel = {k: abs(g_losses[k] - v) / max(abs(v), 1e-12) for k, v in c_losses.items()}
    norm_rel = abs(g_norm - c_norm) / c_norm
    log(f"[parity] FCOS card vs CPU, f32 (CPU runs {cpu_s:.1f} s): one {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} image, max "
        f"|diff| over max |value| per head output: worst {max(head_err.values()):.3e} "
        f"({max(head_err, key=head_err.get)}; tol {HEAD_ATOL}); {int(dets[0]['valid'].sum())} CPU / "
        f"{int(dets[1]['valid'].sum())} card detections, {frac:.4f} matched (label, IoU >= 0.999, |dscore| <= "
        f"1e-4); train pass at batch {NEW_B}: point labels agree on {agree:.6f} of {c_labels.numel()} (min "
        f"{LABEL_AGREE}; CPU {int((c_labels > 0).sum())} foreground); losses card "
        f"{', '.join(f'{k} {v:.6f}' for k, v in g_losses.items())} / CPU "
        f"{', '.join(f'{k} {v:.6f}' for k, v in c_losses.items())}, worst rel diff {max(rel.values()):.3e} (tol "
        f"{LOSS_RTOL}); gradient norm {g_norm:.6f} card / {c_norm:.6f} CPU, rel diff {norm_rel:.3e} (tol "
        f"{GRAD_NORM_RTOL})")
    check(max(head_err.values()) <= HEAD_ATOL, f"FCOS head outputs differ between card and CPU: {head_err}")
    check(np.isfinite(dets[1]["boxes"]).all() and dets[1]["valid"].any(), "card detections empty or non-finite")
    check(frac >= FRCNN_AGREE, f"only {frac:.3f} of the CPU's FCOS detections matched on the card")
    check(agree >= LABEL_AGREE and int((c_labels > 0).sum()) > 0, f"FCOS point labels agree on {agree:.6f}")
    check(max(rel.values()) <= LOSS_RTOL, f"FCOS train losses differ between card and CPU: {rel}")
    check(norm_rel <= GRAD_NORM_RTOL, f"FCOS gradient norms differ by {norm_rel:.3e}")


def _layer_profile(module, *args):
    """One forward of ``module`` with gradients, in IEEE f32 as the step runs it, after one
    unrecorded forward: {child: (the most one call of that child allocated above what was allocated
    when it began (its output, what autograd saves, its workspaces), GiB; the device time of all
    its calls, ms, CUDA events around each)}."""
    from basedet_tpu_torch.layers.common.function import full_f32

    seen, hooks = {}, []

    def pre(_, __):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pre.base = torch.cuda.memory_allocated()
        pre.start = torch.cuda.Event(enable_timing=True)
        pre.start.record()

    def post(name):
        def hook(_, __, ___):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            torch.cuda.synchronize()
            gib, ms = seen.get(name, (0.0, 0.0))
            seen[name] = (max(gib, (torch.cuda.max_memory_allocated() - pre.base) / 2**30),
                          ms + pre.start.elapsed_time(end))
        return hook

    with torch.enable_grad(), full_f32():
        module(*args)
        for name, child in module.named_children():
            hooks += [child.register_forward_pre_hook(pre), child.register_forward_hook(post(name))]
        try:
            module(*args)
        finally:
            for h in hooks:
                h.remove()
    return seen


def _new_stage_times(name, model, batch, timed):
    """The stages of ``name``'s train step, each timed alone on the previous one's outputs; the
    most the head's forward (its outputs and saved activations, workspaces) allocates above the
    features; its layers' device times summed over the levels and over the layers of one kind
    (the four ``cls_subnet_<i>``, ...), and the three layers whose one call allocates the most; and the head's forward with TF32 allowed
    (torch's default for cuDNN): ({stage: ms}, a note). Every stage's tensors are gone when it
    returns, so the step timed after it starts from the model, its state and the batch alone."""
    from basedet_tpu_torch.layers.common.function import topk_scores
    from basedet_tpu_torch.ops.iou_kernel import box_iou

    m = model.module
    x = model.pre_process(batch, train=True)
    gt, nv = x["gt_boxes"], x["img_info"][:, 4].long()
    t = {}
    t["backbone+FPN"], feats = timed(lambda: m.features(x["image"]))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t["head"], head_out = timed(lambda: m.head(feats))
    head_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        head_tf32 = cuda_ms(lambda: m.head(feats), reps=NEW_REPS)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    layers = _layer_profile(m.head, feats)
    by_mem = sorted(layers.items(), key=lambda kv: -kv[1][0])[:3]
    by_kind = {}  # cls_subnet_0 .. cls_subnet_3 → cls_subnet
    for k, (_, ms) in layers.items():
        kind = k.rstrip("0123456789").rstrip("_")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    head_note = (f"; the head's forward allocates up to {head_peak:.2f} GiB above the features, the most in one "
                 f"call of {', '.join(f'{k} {v[0]:.2f}' for k, v in by_mem)} GiB; its layers' device time "
                 f"{sum(v[1] for v in layers.values()):.3f} ms over the 5 levels (CUDA events around each call), "
                 f"by kind {', '.join(f'{k} {v:.3f}' for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1]))} "
                 f"ms (each call synchronised); the head's forward with TF32 allowed {head_tf32:.3f} ms")
    if name == "FreeAnchor":
        anchors = torch.cat(model.anchors(head_out[0]), dim=0)
        logits, offsets = (torch.cat(v, dim=1) for v in model.flatten(*head_out))
        t["assignment"], a = timed(lambda: model.assign(anchors, offsets.detach(), gt, nv))
        t["losses"], _ = timed(lambda: model.bag_losses(anchors, torch.sigmoid(logits), offsets, gt, nv, a))
        quality = torch.where(a["gt_valid"][..., None], box_iou(gt[..., :4].contiguous(), anchors), -1.0)
        sorts = {k: cuda_ms(lambda: topk_scores(quality, k), reps=NEW_REPS) for k in (128, 50)}
        library = cuda_ms(lambda: torch.topk(quality, 128, dim=-1), reps=NEW_REPS)
        return t, (f"{head_note}; its stable sorts of {tuple(quality.shape)} (topk_scores, lowest index first among ties) "
                   f"{sorts[128]:.3f} ms for the top 128 and {sorts[50]:.3f} ms for the top 50, torch.topk(128) "
                   f"{library:.3f} ms (no tie order)")
    points_l = model.points(head_out[0])
    flat = [torch.cat(v, dim=1) for v in model.flatten(*head_out)]
    args = (flat[1].detach(), flat[0].detach()) if name == "OTA" else ()
    t["assignment"], targets = timed(lambda: model.ground_truth(points_l, gt, nv, *args))
    t["losses"], _ = timed(lambda: model.losses(*flat, *targets))
    return t, head_note


def phase_new_train_timing(name, weights, card):
    """One f32 train step of ``name`` at batch NEW_B of 800x1333 (input on the card): backbone + FPN,
    head, the assignment and the losses, each timed alone on the previous stage's outputs with
    gradients enabled (FreeAnchor: the box probability and the bags, then the bag losses; and its
    two stable sorts of (B, 100, 201,600) alone beside torch.topk); get_losses, get_losses with
    backward and the whole step as nested prefixes; peak memory. Returns the step's ms."""
    from basedet_tpu_torch.layers.common.function import full_f32

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    model, state, step, batch = _new_train_setup(name, weights, "cuda")
    batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    m = model.module

    def timed(fn):
        def run():
            with full_f32():
                return fn()
        return cuda_ms(run, reps=NEW_REPS, warmup=2), run()

    stages, extra = _new_stage_times(name, model, batch, timed)

    def losses_backward():
        m.zero_grad(set_to_none=True)
        model.get_losses(batch)[0].backward()

    t_loss, _ = timed(lambda: model.get_losses(batch)[0])
    t_fb, _ = timed(losses_backward)
    torch.cuda.reset_peak_memory_stats()
    t_step = cuda_ms(lambda: step(state, batch), reps=NEW_REPS, warmup=2)
    peak = torch.cuda.max_memory_allocated() - before
    log(f"[timing] {name} R50-FPN f32 train step, batch {NEW_B} of {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]}: {t_step:.3f} ms "
        f"per step ({1000 * NEW_B / t_step:.2f} img/s); each alone, gradients enabled: "
        f"{', '.join(f'{k} {v:.3f}' for k, v in stages.items())} ms; get_losses {t_loss:.3f} ms, "
        f"backward {t_fb - t_loss:.3f} ms, SGD {t_step - t_fb:.3f} ms (differences of means of {NEW_REPS} runs of "
        f"nested prefixes); peak memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated above what the "
        f"script held before this model was built: its weights, gradients and SGD state, the batch, the "
        f"step's activations and workspaces){extra}, input already on the card | {card}")
    return t_step


def phase_new_inference_timing(name, model, card):
    """``name``'s f32 inference at batch 1 of 800x1333, input on the card: the whole request, the
    network, the per-level top-1000 + decode and NMS with the rescale, each alone, means of MODEL_REPS."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.layers.common.post_processing import post_processing

    test_cfg = model.cfg.TEST
    batch = _timing_batch(1, FRCNN_IMAGE)
    total = cuda_ms(lambda: model.inference(batch), reps=MODEL_REPS, warmup=2)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model.inference(batch)
    weights = sum(t.numel() * t.element_size() for t in model.module.state_dict().values())
    peak = torch.cuda.max_memory_allocated() - base + weights
    with torch.inference_mode(), full_f32():
        x = model.pre_process(batch)
        image, info = x["image"], x["img_info"]
        t_net = cuda_ms(lambda: model.module(image), reps=MODEL_REPS, warmup=2)
        head_out = model.module(image)
        places = model.anchors(head_out[0]) if name == "FreeAnchor" else model.points(head_out[0])
        flat = model.flatten(*head_out)
        t_topk = cuda_ms(lambda: model.candidates(*flat, places), reps=MODEL_REPS, warmup=2)
        cands = model.candidates(*flat, places)
        t_nms = cuda_ms(lambda: post_processing(*cands, info, test_cfg.IOU_THRESHOLD, test_cfg.MAX_BOXES_PER_IMAGE),
                        reps=MODEL_REPS, warmup=2)
    log(f"[timing] {name} R50-FPN f32 {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} batch 1: {total:.3f} ms per request; "
        f"network {t_net:.3f}, top-1000 per level + decode {t_topk:.3f}, NMS at K = {cands[1].shape[1]} + rescale "
        f"{t_nms:.3f} ms (each alone, means of {MODEL_REPS}); peak memory {peak / 2**30:.2f} GiB (the model's weights and "
        f"the request's torch.cuda.max_memory_allocated above what was held before it), input already on the card "
        f"| {card}")
    return total


def phase_new_models(out_dir, card):
    """29-34: FCOS (trained from the backbone-only reference-layout pickle), ATSS, OTA and
    FreeAnchor through det_train and det_test, their kernels held on their own steps' arguments and
    timed, OTA's Sinkhorn step, FCOS card against CPU, every step and request timed."""
    models = {}
    backbone = make_backbone_pickle(out_dir)
    for name in NEW_MODELS:
        cfg, model, weights = make_new_weights(out_dir, name)
        calls, dumped = phase_new_train(out_dir, name, weights, backbone if name == "FCOS" else None)
        if calls:
            phase_new_kernels(name, calls, card)
        del calls
        phase_new_slice(out_dir, name, weights if name == "FCOS" else dumped)
        if name == "FCOS":
            phase_fcos_card_vs_cpu(cfg, model, weights)
        if name == "OTA":
            phase_ota_sinkhorn(weights)
        phase_new_train_timing(name, weights, card)
        models[name] = model
    for name, model in models.items():
        phase_new_inference_timing(name, model, card)


# -- YOLOv3 and DETR: det_train and det_test at full width ------------------------------------------

YOLOV3_CONFIG = "basedet_tpu_torch/playground/yolov3_darknet53/config.py"
DETR_CONFIG = "basedet_tpu_torch/playground/detr_r50_150e/config.py"
YOLOV3_B, DETR_B, LAST_STEPS, LAST_REQUESTS = 8, 2, 2, 8  # the configs' batches; DummyLoader's 8 requests
YOLOV3_ROWS = 3 * sum((800 // s) * (1344 // s) for s in (32, 16, 8))  # 66,150 at 800x1344
YOLOV3_K = 3 * 1000  # top-1000 per level, class-aware NMS
YOLOV3_IOU_CALLS = 2  # a step: the anchor match, the ignore mask over the three levels in one call


@torch.no_grad()
def randomise_yolov3(module, generator):
    """BN statistics and affine and every bias drawn from generator as ``randomise`` draws them; the
    prediction convs' objectness and class biases spread by 2 around -2, so that conf·cls spreads
    (a few classes dominate: same-class neighbours overlap and NMS suppresses) and the decoded
    boxes' sizes stay near their anchors' (some pass IoU 0.7 with a gt: the ignore mask is neither
    empty nor full)."""
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0.0, 0.2, generator=generator)
            m.running_var.uniform_(0.5, 2.0, generator=generator)
            m.weight.uniform_(0.5, 1.5, generator=generator)
        if getattr(m, "bias", None) is not None:
            m.bias.add_(torch.empty_like(m.bias).normal_(0.0, 0.3, generator=generator))
    for name, m in module.fpn.named_children():
        if name.endswith("_pred"):
            per_anchor = m.bias.view(3, -1)
            per_anchor[:, 4:].normal_(-2.0, 2.0, generator=generator)


@torch.no_grad()
def randomise_detr(module, generator):
    """The frozen BN statistics and affine and every bias drawn from generator, as
    ``randomise_retina`` draws them, the class biases spread by 2."""
    from basedet_tpu_torch.layers.common.blocks import FrozenBatchNorm

    for m in module.modules():
        if isinstance(m, FrozenBatchNorm):
            m.running_mean.normal_(0.0, 0.2, generator=generator)
            m.running_var.uniform_(0.5, 2.0, generator=generator)
            m.weight.uniform_(0.5, 1.5, generator=generator)
        if getattr(m, "bias", None) is not None:
            m.bias.add_(torch.empty_like(m.bias).normal_(0.0, 0.3, generator=generator))
    module.class_embed.bias.add_(torch.empty_like(module.class_embed.bias).normal_(0.0, 2.0, generator=generator))


LAST = {  # model: (config, batch, randomise)
    "YOLOv3": (YOLOV3_CONFIG, YOLOV3_B, randomise_yolov3),
    "DETR": (DETR_CONFIG, DETR_B, randomise_detr),
}


def _last_opts(out_dir):
    return ["DATA.TEST.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", str(FRCNN_IMAGE).replace(" ", ""),
            "GLOBAL.OUTPUT_DIR", out_dir]


def _last_train_opts(out_dir, name, weights, batch):
    return [*_last_opts(out_dir), "DATA.TRAIN.name", "dummy", "MODEL.BATCHSIZE", str(batch), "SOLVER.MAX_EPOCH",
            "1", "SOLVER.NUM_IMAGE_PER_EPOCH", str(LAST_STEPS * batch), "GLOBAL.LOG_INTERVAL", "1",
            "MODEL.WEIGHTS", weights, "GLOBAL.CKPT_SAVE_DIR", os.path.join(out_dir, f"{name}_ckpt")]


def make_last_weights(out_dir, name):
    """Full-width ``name`` on the card with random weights from SEED, spread, saved as a state_dict.
    Returns (cfg for det_test, model, path)."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.tools import import_config

    config, _, spread = LAST[name]
    cfg = import_config(config)
    cfg.merge(_last_opts(out_dir))
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    model = build_model(cfg, "cuda", generator)
    spread(model.module, generator)
    weights = os.path.join(out_dir, f"{name.lower()}_seed0.pt")
    torch.save(model.module.state_dict(), weights)
    m = cfg.MODEL
    what = (f"Darknet-53 (train-mode BN) + YOLOFPN, anchors {[len(a) for a in m.ANCHOR.SCALES]} a level, ignore "
            f"threshold {m.IGNORE_THRESHOLD}" if name == "YOLOv3" else
            f"{m.BACKBONE.NAME} (FrozenBN, freeze_at {m.BACKBONE.FREEZE_AT}), {m.TRANSFORMER.NUM_ENCODERS} + "
            f"{m.TRANSFORMER.NUM_DECODERS} layers of width {m.TRANSFORMER.DIM}, {m.TRANSFORMER.NUM_HEADS} heads, FFN "
            f"{m.TRANSFORMER.DIM_FFN}, dropout {m.TRANSFORMER.DROPOUT}, {m.NUM_QUERIES} queries")
    log(f"[{name.lower()}] {config}: {what}, {cfg.DATA.NUM_CLASSES} classes, "
        f"{sum(p.numel() for p in model.module.parameters())} parameters, random from seed {SEED}")
    return cfg, model, weights


def phase_last_train(out_dir, name, weights):
    """det_train on full-width ``name``, LAST_STEPS steps of its config's batch of 800x1333, every
    kernel's and plain version's count zeroed just before and read just after. YOLOv3: #10 twice a
    step (its calls' arguments kept), the ignore mask neither empty nor full; DETR: no kernel, the
    auction's rounds and host syncs per call, dropout drawn from the step's generator. Returns (the
    kernels' calls, the dumped weights)."""
    from basedet_tpu_torch.layers.common.matcher import AuctionStats
    from basedet_tpu_torch.models import det
    from basedet_tpu_torch.models.det import detr, yolov3
    from basedet_tpu_torch.tools import det_train

    config, batch, _ = LAST[name]
    path = f"{name} det_train"
    keep_args = lambda args, out: tuple(a.clone() for a in args)
    keep_losses = lambda args, out: {k: float(v.detach()) for k, v in out[1].items()}
    auction = lambda args, out: (AuctionStats.rounds, AuctionStats.syncs, int(AuctionStats.needed.max()),
                                 AuctionStats.completed, tuple(args[0].shape))
    with contextlib.ExitStack() as stack:
        losses = stack.enter_context(recording(getattr(det, name), "get_losses", keep_losses))
        if name == "YOLOv3":
            calls = stack.enter_context(recording(yolov3, "box_iou", keep_args))
            ignored = stack.enter_context(recording(det.YOLOv3, "ignore_mask",
                                                    lambda args, out: float(out.float().mean())))
        else:
            calls = stack.enter_context(recording(detr, "hungarian_match_owner", auction))
            drawn = stack.enter_context(recording(det.DETR, "dropout_generator", lambda args, out: out is not None))
        stack.enter_context(kernel_counts(path))
        t0 = time.perf_counter()
        trainer = det_train.main(["-f", config, "--device", "cuda", *_last_train_opts(out_dir, name, weights, batch)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    steps = trainer.state.step
    check(steps == LAST_STEPS and len(losses) == LAST_STEPS, f"{name} det_train took {steps} steps")
    per_step = {"box_iou": YOLOV3_IOU_CALLS} if name == "YOLOv3" else {}
    counts = _new_counts(path, {k: n * steps for k, n in per_step.items()})
    check(all(math.isfinite(v) for step in losses for v in step.values()), f"non-finite {name} losses {losses}")
    check(all(step["total_loss"] > 0 for step in losses), f"{name} losses {losses}")
    ckpt = os.path.join(out_dir, f"{name}_ckpt")
    for f in ("latest.pt", "epoch_1.pt", "dumped_model.pt"):
        check(os.path.exists(os.path.join(ckpt, f)), f"{name} det_train wrote no {f}")
    per = "; ".join(", ".join(f"{k} {v:.4f}" for k, v in step.items()) for step in losses)
    if name == "YOLOv3":
        check(len(calls) == YOLOV3_IOU_CALLS * steps, f"YOLOv3: {len(calls)} recorded IoU calls")
        (a1, a2), (i1, i2) = calls[0], calls[1]
        check(tuple(a1.shape) == (batch, 100, 4) and tuple(a2.shape) == (9, 4)
              and tuple(i1.shape) == (batch, YOLOV3_ROWS, 4) and tuple(i2.shape) == (batch, 100, 4),
              f"YOLOv3's IoU calls took {[(tuple(a.shape), tuple(b.shape)) for a, b in calls[:2]]}")
        check(all(0.0 < f < 1.0 for f in ignored), f"the ignore mask is empty or full: {ignored}")
        extra = (f"; #10 per step at (B, K, 4) x (9, 4) then (B, R, 4) x (B, K, 4) = {tuple(i1.shape)} x "
                 f"{tuple(i2.shape)}; ignored share of rows per step {', '.join(f'{f:.5f}' for f in ignored)}")
    else:
        check(len(calls) == steps and all(d for d in drawn) and len(drawn) == steps,
              f"DETR: {len(calls)} auction calls, dropout generators {drawn}")
        extra = "; auction per step (problems x Q x K, rounds run, rounds needed, host syncs, greedy completion): " + \
            "; ".join(f"{shape} {r} run, {n} needed, {s} syncs, completion {c}" for r, s, n, c, shape in calls) + \
            "; dropout 0.1 from the step's generator"
    log(f"[{name.lower()}-train] det_train {name}, {steps} steps of {batch} images {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} "
        f"(padded 800x1344), f32, in {seconds:.2f} s; kernel launches {counts}; losses per step: {per}{extra}")
    return calls, os.path.join(ckpt, "dumped_model.pt")


def phase_yolov3_kernels(calls, card):
    """#10 against its plain version on YOLOv3's first step's own two calls, bit for bit, two runs
    bit-equal, and timed. Returns {call: (err, device ms)} for the report."""
    from basedet_tpu_torch.ops.iou_kernel import box_iou

    for i, (b1, b2) in enumerate(calls[:YOLOV3_IOU_CALLS]):
        err, bits = check_iou_case(b1, b2)
        repeat = torch.equal(box_iou(b1, b2).view(torch.int32), box_iou(b1, b2).view(torch.int32))
        what = ("anchor match" if i == 0 else "ignore mask")
        log(f"[iou] YOLOv3 step 1 {what}: {tuple(b1.shape)} x {tuple(b2.shape)}: max |kernel - plain| {err:.3e}, "
            f"bit-equal {bits}, two runs bit-equal {repeat}")
        check(bits and repeat, f"the IoU kernel on YOLOv3's {what}: bit-equal {bits}, repeat {repeat}")
        _iou_timing(f"YOLOv3 {what}", b1, b2, card)


def phase_last_slice(out_dir, name, weights):
    """det_test on ``name`` over LAST_REQUESTS requests of one 800x1333 image, counts zeroed just
    before and read just after: YOLOv3's NMS once a request at K = 3000, suppressing; DETR no kernel
    (one detection per query). Every plain version 0 times."""
    from basedet_tpu_torch.ops import nms as nms_ops
    from basedet_tpu_torch.tools import det_test

    from basedet_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain

    path = f"{name} det_test"
    seen = lambda args, keep: (args[0].shape[1], list(zip(args[1].sum(1).tolist(), keep.sum(1).tolist())),
                               args if not calls else None)
    t0 = time.perf_counter()
    with recording(nms_ops, "nms_keep", seen) as calls, kernel_counts(path):
        results = det_test.main(["-f", LAST[name][0], "-w", weights, "--device", "cuda", *_last_opts(out_dir)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _new_counts(path, {"nms_keep": LAST_REQUESTS} if name == "YOLOv3" else {})
    with open(os.path.join(out_dir, "predict_coco.json")) as f:
        records = json.load(f)
    check(np.isfinite([r["bbox"] + [r["score"]] for r in records]).all(), f"non-finite {name} detections")
    check({r["image_id"] for r in records} == set(range(LAST_REQUESTS)), f"not every {name} request was answered")
    if name == "YOLOv3":
        check(all(k == YOLOV3_K for k, _, _ in calls), f"YOLOv3's NMS took {[k for k, _, _ in calls]} candidates")
        check(any(k < v for _, call, _ in calls for v, k in call), "YOLOv3's NMS suppressed nothing on the main path")
        boxes, valid, t = calls[0][2]
        keep = nms_keep(boxes, valid, t)
        check(torch.equal(keep, nms_keep_plain(boxes, valid, t)), "the NMS kernel differs from its plain version on "
                                                                    "YOLOv3's first request")
        ms = cuda_ms(lambda: nms_keep(boxes, valid, t), reps=50, warmup=5)
        plain_ms = cuda_ms(lambda: nms_keep_plain(boxes, valid, t), reps=3, warmup=1)
        bound_ms, bound_by = nms_bound(valid, keep)
        extra = (f", NMS at K = {YOLOV3_K}; NMS kept per image {_kept_range([c for _, c, _ in calls])}; on the first "
                 f"request's own arguments the kernel equals its plain version, kernel {ms:.4f} ms, plain {plain_ms:.3f}"
                 f" ms a call, bound {bound_ms:.6f} ms ({bound_by}); {_nms_split(boxes, valid, t)}")
    else:
        check(len(records) == LAST_REQUESTS * 100, f"DETR answered {len(records)} detections, not 100 a request")
        extra = ", one detection per query, no NMS"
    log(f"[{name.lower()}] det_test {name} with {os.path.basename(weights)} on {LAST_REQUESTS} requests of "
        f"{FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]}: {results}, {len(records)} finite detections in {seconds:.2f} s; kernel "
        f"launches {counts}{extra}")


def _last_train_setup(name, weights, device, extra=()):
    """Full-width ``name`` in train mode with ``weights``, its solver's train state and step, and
    the first synthetic batch of the config's size of 800x1333."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.data import DataloaderBuilder
    from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
    from basedet_tpu_torch.tools import import_config
    from basedet_tpu_torch.utils.registry import registers

    config, batch, _ = LAST[name]
    cfg = import_config(config)
    cfg.merge([*_last_train_opts(".", name, weights, batch), *extra])
    model = build_model(cfg, device)
    model.load_weights(weights)
    solver = registers.solvers.get(cfg.SOLVER.BUILDER_NAME).build(cfg)
    state = TrainState(model.train(), solver)
    return model, state, make_train_step(model, solver, cfg), next(DataloaderBuilder.build(cfg))


def _grad_norm(module):
    return float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in module.parameters() if p.grad is not None)))


def _rel_to_max(got, want):
    return float((got.cpu() - want.cpu()).abs().max() / want.abs().max())


def _yolov3_pass(model, batch):
    """YOLOv3 at batch 2 on one device, f32: the eval-mode maps and detections, then one train-mode
    get_losses and backward: losses, gradient norm, the new BN running statistics."""
    from basedet_tpu_torch.layers.common.function import full_f32

    with torch.inference_mode(), full_f32():
        maps = [x.cpu() for x in model.module.eval()(model.pre_process(batch)["image"])]
    dets = {k: v.cpu().numpy() for k, v in model.inference(batch).items()}
    model.train()
    with full_f32():
        model.module.zero_grad(set_to_none=True)
        total, losses = model.get_losses(batch)
        total.backward()
    stats = {k: v.detach().cpu() for k, v in model.module.state_dict().items() if "running" in k}
    return maps, dets, {k: float(v.detach()) for k, v in losses.items()}, _grad_norm(model.module), stats


def phase_yolov3_card_vs_cpu(weights):
    """YOLOv3 card against CPU, f32, TF32 off, the same weights and batch of 2 of 800x1333: the
    three eval maps (HEAD_ATOL of each map's largest value), the detections (FRCNN_AGREE matched),
    one train pass's losses (LOSS_RTOL), gradient norm (GRAD_NORM_RTOL) and new BN running
    statistics (STATS_RTOL of max(|value|, 1))."""
    from basedet_tpu_torch.utils.compare import match_detections

    t0 = time.perf_counter()
    runs = {}
    for device in ("cpu", "cuda"):
        model, _, _, batch = _last_train_setup("YOLOv3", weights, device, ["MODEL.BATCHSIZE", "2"])
        runs[device] = _yolov3_pass(model, batch)
        del model
        if device == "cpu":
            cpu_s = time.perf_counter() - t0
    (c_maps, c_dets, c_loss, c_norm, c_stats), (g_maps, g_dets, g_loss, g_norm, g_stats) = runs["cpu"], runs["cuda"]
    map_err = [_rel_to_max(g, c) for g, c in zip(g_maps, c_maps)]
    frac = match_detections(c_dets, g_dets)
    rel = {k: abs(g_loss[k] - v) / max(abs(v), 1e-12) for k, v in c_loss.items()}
    norm_rel = abs(g_norm - c_norm) / c_norm
    stats_rel = max(float((g_stats[k] - v).abs().max()) / max(1.0, float(v.abs().max())) for k, v in c_stats.items())
    log(f"[parity] YOLOv3 card vs CPU, f32 (CPU runs {cpu_s:.1f} s), batch 2 of {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]}: "
        f"eval maps max |diff| over max |value| {', '.join(f'{e:.3e}' for e in map_err)} (strides 32, 16, 8; tol "
        f"{HEAD_ATOL}); {int(c_dets['valid'].sum())} CPU / {int(g_dets['valid'].sum())} card detections, {frac:.4f} "
        f"matched; train pass losses card {', '.join(f'{k} {v:.6f}' for k, v in g_loss.items())} / CPU "
        f"{', '.join(f'{k} {v:.6f}' for k, v in c_loss.items())}, worst rel diff {max(rel.values()):.3e} (tol "
        f"{LOSS_RTOL}); gradient norm {g_norm:.6f} / {c_norm:.6f}, rel diff {norm_rel:.3e} (tol {GRAD_NORM_RTOL}); "
        f"new BN running statistics worst {stats_rel:.3e} of max(|value|, 1) (tol {STATS_RTOL})")
    check(max(map_err) <= HEAD_ATOL, f"YOLOv3 maps differ between card and CPU: {map_err}")
    check(np.isfinite(g_dets["boxes"]).all() and g_dets["valid"].any(), "card detections empty or non-finite")
    check(frac >= FRCNN_AGREE, f"only {frac:.3f} of the CPU's YOLOv3 detections matched on the card")
    check(max(rel.values()) <= LOSS_RTOL, f"YOLOv3 train losses differ between card and CPU: {rel}")
    check(norm_rel <= GRAD_NORM_RTOL, f"YOLOv3 gradient norms differ by {norm_rel:.3e}")
    check(stats_rel <= STATS_RTOL, f"YOLOv3 BN running statistics differ by {stats_rel:.3e}")


def _detr_pass(model, batch):
    """DETR at batch 2 on one device, f32, dropout 0: every decoder layer's logits and boxes, the
    owners, then get_losses and backward: losses and gradient norm."""
    from basedet_tpu_torch.layers.common.function import full_f32

    model.train()
    with torch.no_grad(), full_f32():
        x = model.prepare(batch, train=True)
        logits, coords = model.module(x["image"], x["mask"])
        targets = model.targets(x["gt_boxes"], x["img_info"])
        owner = model.match(logits, coords, *targets[:3])
        cost = model.matching_cost(logits.flatten(0, 1), coords.flatten(0, 1),
                                   *(t.expand(logits.shape[0], *t.shape).flatten(0, 1) for t in targets[:2]))
    with full_f32():
        model.module.zero_grad(set_to_none=True)
        total, losses = model.get_losses(batch)
        total.backward()
    return (logits.cpu(), coords.cpu(), owner.cpu(), cost.cpu(), targets[2].cpu(),
            {k: float(v.detach()) for k, v in losses.items()}, _grad_norm(model.module))


def phase_detr_card_vs_cpu(weights):
    """DETR card against CPU, f32, TF32 off, dropout 0, the same weights and batch of 2: every
    decoder layer's logits and boxes (HEAD_ATOL of each one's largest value), the owners (equal, or
    each differing problem's total cost on the CPU's cost within the auction's eps bound), losses
    (LOSS_RTOL) and gradient norm (GRAD_NORM_RTOL)."""
    t0 = time.perf_counter()
    runs = {}
    for device in ("cpu", "cuda"):
        model, _, _, batch = _last_train_setup("DETR", weights, device, ["MODEL.TRANSFORMER.DROPOUT", "0.0"])
        runs[device] = _detr_pass(model, batch)
        del model
        if device == "cpu":
            cpu_s = time.perf_counter() - t0
    c_logits, c_coords, c_owner, c_cost, valid, c_loss, c_norm = runs["cpu"]
    g_logits, g_coords, g_owner, _, _, g_loss, g_norm = runs["cuda"]
    L = c_logits.shape[0]
    logit_err = [_rel_to_max(g_logits[i], c_logits[i]) for i in range(L)]
    box_err = [_rel_to_max(g_coords[i], c_coords[i]) for i in range(L)]
    differ = (c_owner != g_owner).any(dim=-1).flatten()  # (layers x images) problems
    cost, v = c_cost, valid.expand(L, *valid.shape).flatten(0, 1)  # (P, Q, K), (P, K)

    def total_cost(owner):
        o = owner.flatten(0, 1)
        return torch.where(v, cost.gather(1, o.clamp(min=0)[:, None, :])[:, 0], 0.0).sum(-1)

    gap = (total_cost(g_owner) - total_cost(c_owner)).abs()
    vmax = torch.where(v[:, None], cost, -torch.inf).amax((1, 2))
    vmin = torch.where(v[:, None], cost, torch.inf).amin((1, 2))
    bound = v.sum(-1) * 2e-3 * (vmax - vmin)  # eps-optimality: V x eps
    rel = {k: abs(g_loss[k] - x) / max(abs(x), 1e-12) for k, x in c_loss.items()}
    norm_rel = abs(g_norm - c_norm) / c_norm
    log(f"[parity] DETR card vs CPU, f32, dropout 0 (CPU runs {cpu_s:.1f} s), batch 2 of {FRCNN_IMAGE[0]}x"
        f"{FRCNN_IMAGE[1]}: per decoder layer, max |diff| over max |value|, logits "
        f"{', '.join(f'{e:.3e}' for e in logit_err)}, boxes {', '.join(f'{e:.3e}' for e in box_err)} (tol {HEAD_ATOL}); "
        f"owners equal in {int((~differ).sum())} of {differ.numel()} (layer, image) problems"
        f"{f'; the others assign a total cost on the CPU cost {float(gap[differ].max()):.3e} from the CPU owners (a near-tie; the auction eps bound V x eps {float(bound[differ].min()):.3e})' if differ.any() else ''}"
        f"; losses card {', '.join(f'{k} {x:.6f}' for k, x in g_loss.items())} / CPU "
        f"{', '.join(f'{k} {x:.6f}' for k, x in c_loss.items())}, worst rel diff {max(rel.values()):.3e} (tol "
        f"{LOSS_RTOL}); gradient norm {g_norm:.6f} / {c_norm:.6f}, rel diff {norm_rel:.3e} (tol {GRAD_NORM_RTOL})")
    check(max(logit_err + box_err) <= HEAD_ATOL, f"DETR decoder outputs differ: {logit_err}, {box_err}")
    check(bool((gap[differ] <= bound[differ]).all()), f"DETR owners differ beyond a near-tie: {gap[differ]}")
    check(max(rel.values()) <= LOSS_RTOL, f"DETR train losses differ between card and CPU: {rel}")
    check(norm_rel <= GRAD_NORM_RTOL, f"DETR gradient norms differ by {norm_rel:.3e}")


def _step_timing(name, model, state, step, batch, before, stages, card, notes=""):
    """Log ``name``'s step: each stage alone ({stage: ms}), get_losses, get_losses + backward and the
    whole step as nested prefixes, and the peak above ``before`` (bytes held before the model was
    built)."""
    from basedet_tpu_torch.layers.common.function import full_f32

    m = model.module

    def run(fn):
        with full_f32():
            return fn()

    def losses_backward():
        m.zero_grad(set_to_none=True)
        model.get_losses(batch)[0].backward()

    t_loss = cuda_ms(lambda: run(lambda: model.get_losses(batch)[0]), reps=NEW_REPS, warmup=2)
    t_fb = cuda_ms(lambda: run(losses_backward), reps=NEW_REPS, warmup=2)
    t_opt = cuda_ms(state.optimizer.step, reps=NEW_REPS, warmup=1)  # on the last backward's gradients
    torch.cuda.reset_peak_memory_stats()
    t_step = cuda_ms(lambda: step(state, batch), reps=NEW_REPS, warmup=2)
    peak = torch.cuda.max_memory_allocated() - before
    optimizer = type(state.optimizer).__name__
    log(f"[timing] {name} f32 train step, batch {LAST[name][1]} of {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]}: {t_step:.3f} ms "
        f"per step ({1000 * LAST[name][1] / t_step:.2f} img/s); each alone, gradients enabled: "
        f"{', '.join(f'{k} {v:.3f}' for k, v in stages.items())} ms; get_losses {t_loss:.3f} ms, get_losses with "
        f"backward {t_fb:.3f} ms (backward {t_fb - t_loss:.3f} by difference), {optimizer}'s step alone "
        f"{t_opt:.3f} ms (means of {NEW_REPS} runs); peak memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated above what the script held before this model was built){notes}, input "
        f"already on the card | {card}")
    return t_step


def _timed(fn):
    from basedet_tpu_torch.layers.common.function import full_f32

    def run():
        with full_f32():
            return fn()
    return cuda_ms(run, reps=NEW_REPS, warmup=2), run()


def phase_yolov3_train_timing(weights, card):
    """One f32 YOLOv3 train step at batch 8 of 800x1333, input on the card: backbone, FPN, targets +
    ignore mask (#10 twice), losses, each alone on the previous stage's outputs with gradients
    enabled; then get_losses, backward and SGD; the step's own peak memory."""
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    model, state, step, batch = _last_train_setup("YOLOv3", weights, "cuda")
    batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    m = model.module
    x = model.pre_process(batch, train=True)
    gt, nv = x["gt_boxes"], x["img_info"][:, 4].to(torch.int32)
    t = {}
    t["backbone"], feats = _timed(lambda: m.bottom_up(x["image"]))
    t["FPN"], preds = _timed(lambda: m.fpn([feats["dark3"], feats["dark4"], feats["dark5"]]))
    pred, grid, hw = model.flatten(preds), model.grids(preds), [tuple(p.shape[-2:]) for p in preds]

    def targets():
        return (model.targets(gt, nv, hw, float(x["image"].shape[2])),
                model.ignore_mask(model.decode(pred.detach(), grid), gt, nv))

    t["targets + ignore mask"], (tg, ignore) = _timed(targets)
    t["losses"], losses = _timed(lambda: model.losses(pred, tg, ignore))
    del feats, preds, pred, tg, ignore, losses  # the losses' graph would hold the forward's activations
    return _step_timing("YOLOv3", model, state, step, batch, before, t, card)


def phase_detr_train_timing(weights, card):
    """One f32 DETR train step at batch 2 of 800x1333, dropout 0.1 from the step's generator, input
    on the card: backbone (+ input_proj, mask, position embedding), encoder, decoder, heads,
    matching (its cost and its auction apart, the rounds and host syncs), losses, each alone; then
    get_losses, backward and AdamW; the step's own peak memory."""
    from basedet_tpu_torch.layers.common.matcher import AuctionStats, hungarian_match_owner

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    model, state, step, batch = _last_train_setup("DETR", weights, "cuda")
    batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    m = model.module
    x = model.prepare(batch, train=True)
    g = model.dropout_generator(42, 0)
    t = {}
    t["backbone"], (src, pad, pos) = _timed(lambda: m.features(x["image"], x["mask"]))
    t["encoder"], memory = _timed(lambda: m.transformer.encode(src, pad, pos, g))
    t["decoder"], hs = _timed(lambda: m.transformer.decode(memory, pad, m.query_embed, pos, g))
    t["heads"], (logits, coords) = _timed(lambda: m.heads(hs))
    targets = model.targets(x["gt_boxes"], x["img_info"])
    t["matching"], owner = _timed(lambda: model.match(logits.detach(), coords.detach(), *targets[:3]))
    L = logits.shape[0]
    with torch.no_grad():
        flat = lambda v: v.expand(L, *v.shape).flatten(0, 1)
        t_cost, cost = _timed(lambda: model.matching_cost(logits.flatten(0, 1), coords.flatten(0, 1),
                                                          flat(targets[0]), flat(targets[1])))
        t_auction, _ = _timed(lambda: hungarian_match_owner(cost, flat(targets[2])))
    notes = (f"; of the matching, the cost {t_cost:.3f} ms and the auction {t_auction:.3f} ms alone: "
             f"{owner.shape[0] * owner.shape[1]} (layer, image) problems of {logits.shape[2]} queries x "
             f"{owner.shape[2]} targets, {AuctionStats.rounds} rounds run, {int(AuctionStats.needed.max())} needed, "
             f"{AuctionStats.syncs} host syncs a call")
    t["losses"], losses = _timed(lambda: model.layer_losses(logits, coords, owner, *targets))
    del src, pad, pos, memory, hs, logits, coords, losses  # the losses' graph would hold the activations
    return _step_timing("DETR", model, state, step, batch, before, t, card, notes)


def phase_last_inference_timing(name, model, card):
    """``name``'s f32 inference at batch 1 of 800x1333, input on the card: the whole request, the
    network and the post-process (YOLOv3: the per-level top-1000 + decode, then NMS at K = 3000 with
    the rescale), each alone, means of MODEL_REPS; the request's peak with the weights."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.layers.common.post_processing import post_processing

    batch = _timing_batch(1, FRCNN_IMAGE)
    model.eval()
    total = cuda_ms(lambda: model.inference(batch), reps=MODEL_REPS, warmup=2)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model.inference(batch)
    weights = sum(t.numel() * t.element_size() for t in model.module.state_dict().values())
    peak = torch.cuda.max_memory_allocated() - base + weights
    with torch.inference_mode(), full_f32():
        if name == "YOLOv3":
            x = model.pre_process(batch)
            t_net = cuda_ms(lambda: model.module(x["image"]), reps=MODEL_REPS, warmup=2)
            preds = model.module(x["image"])
            t_topk = cuda_ms(lambda: model.candidates(preds), reps=MODEL_REPS, warmup=2)
            cands = model.candidates(preds)
            test_cfg = model.cfg.TEST
            t_nms = cuda_ms(lambda: post_processing(*cands, x["img_info"], test_cfg.IOU_THRESHOLD,
                                                    test_cfg.MAX_BOXES_PER_IMAGE), reps=MODEL_REPS, warmup=2)
            split = (f"network {t_net:.3f}, top-1000 per level + decode {t_topk:.3f}, NMS at K = {cands[1].shape[1]} "
                     f"+ rescale {t_nms:.3f} ms")
        else:
            x = model.prepare(batch)
            t_net = cuda_ms(lambda: model.module(x["image"], x["mask"]), reps=MODEL_REPS, warmup=2)
            logits, coords = model.module(x["image"], x["mask"])
            t_post = cuda_ms(lambda: model.post_process(logits[-1], coords[-1], x["img_info"]), reps=MODEL_REPS, warmup=2)
            split = f"network {t_net:.3f}, softmax + boxes {t_post:.3f} ms"
    log(f"[timing] {name} f32 {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} batch 1: {total:.3f} ms per request; {split} (each "
        f"alone, means of {MODEL_REPS}); peak memory {peak / 2**30:.2f} GiB (the model's weights and the request's "
        f"torch.cuda.max_memory_allocated above what was held before it), input already on the card | {card}")
    return total


def phase_last_families(out_dir, card):
    """35-38: YOLOv3 and DETR through det_train and det_test, YOLOv3's #10 calls held on its own
    step's arguments and timed, card against CPU, every step and request timed."""
    models = {}
    for name in LAST:
        gc.collect()
        torch.cuda.empty_cache()
        _, model, weights = make_last_weights(out_dir, name)
        calls, dumped = phase_last_train(out_dir, name, weights)
        if name == "YOLOv3":
            phase_yolov3_kernels(calls, card)
        del calls
        phase_last_slice(out_dir, name, dumped)
        (phase_yolov3_card_vs_cpu if name == "YOLOv3" else phase_detr_card_vs_cpu)(weights)
        (phase_yolov3_train_timing if name == "YOLOv3" else phase_detr_train_timing)(weights, card)
        models[name] = model
    for name, model in models.items():
        phase_last_inference_timing(name, model, card)


# -- the bf16 policy (--amp) of the nine other families, and TRAINER.REMAT ------------------------

AMP_FAMILIES = {  # model: (config, batch, image, {kernel: launches per det_train --amp step})
    "RetinaNet": (RETINA_CONFIG, RETINA_B, FRCNN_IMAGE, {"box_iou": 1}),
    "FCOS": (NEW_MODELS["FCOS"][0], NEW_B, FRCNN_IMAGE, {}),
    "ATSS": (NEW_MODELS["ATSS"][0], NEW_B, FRCNN_IMAGE, {"box_iou": 1}),
    "OTA": (NEW_MODELS["OTA"][0], NEW_B, FRCNN_IMAGE, {"dynamic_k_matching": 1}),
    "FreeAnchor": (NEW_MODELS["FreeAnchor"][0], NEW_B, FRCNN_IMAGE, {"box_iou": 2}),
    "Faster R-CNN": (FRCNN_CONFIG, FRCNN_TRAIN_B, FRCNN_IMAGE,
                     {"multilevel_roi_align_bf16": 1, "multilevel_roi_align_backward_bf16": 1, "nms_keep": 1,
                      "box_iou": 2}),
    "CenterNet": (CNET_CONFIG, CNET_B, CNET_IMAGE, {"scatter_rows": 3}),
    "YOLOv3": (YOLOV3_CONFIG, YOLOV3_B, FRCNN_IMAGE, {"box_iou": YOLOV3_IOU_CALLS}),
    "DETR": (DETR_CONFIG, DETR_B, FRCNN_IMAGE, {}),
}
AMP_WEIGHTS = {"RetinaNet": "retinanet_r50_seed0.pt", "Faster R-CNN": "faster_rcnn_r50_seed0.pt",
               "CenterNet": "centernet_r50_seed0.pt", "YOLOv3": "yolov3_seed0.pt", "DETR": "detr_seed0.pt",
               **{name: f"{name.lower()}_r50_seed0.pt" for name in NEW_MODELS}}  # the earlier phases' files
AMP_STEPS, AMP_REPS = 2, 3  # det_train --amp steps; timed steps of each dtype
# the card-vs-CPU bf16 gate at 512x512 (its CPU passes, f32 and bf16, are the phase's cost): {model: (batch,
# BN in eval mode)}, each a setup where bf16 tracks f32. Faster R-CNN at batch 4: its box loss averages the few
# positive RoIs of 3 gts an image, and at batch 2 one RoI sampled otherwise after a bf16 rounding moved it by
# 17% (card 0.0392, CPU bf16 0.0336, f32 0.0389 on both). CenterNet with BN on its running statistics: in train
# mode (FREEZE_AT 0) the stem's and layer1's gradients, most of the norm, are what cancels in the BN backward
# of bf16 activation gradients, and the bf16 gradient is unrelated to the f32 one (the phase reports its cosine)
AMP_GATES, AMP_GATE_IMAGE = {"RetinaNet": (2, False), "Faster R-CNN": (4, False), "CenterNet": (2, True)}, (512, 512)
REMAT_RTOL, REMAT_B16 = 1e-5, 16


def _amp_weights(out_dir, name):
    """The weights an earlier phase saved for ``name`` (random from SEED, spread)."""
    path = os.path.join(out_dir, AMP_WEIGHTS[name])
    check(os.path.exists(path), f"no weights for {name} at {path}")
    return path


def _amp_opts(out_dir, name, weights=None, batch=None, image=None):
    """det_train (with ``weights``) or det_test options of ``name``'s --amp path."""
    _, b, img, _ = AMP_FAMILIES[name]
    b, img = batch or b, image or img
    opts = ["DATA.TEST.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", str(tuple(img)).replace(" ", ""), "GLOBAL.OUTPUT_DIR",
            out_dir]
    if weights is None:
        return opts
    return [*opts, "DATA.TRAIN.name", "dummy", "MODEL.BATCHSIZE", str(b), "SOLVER.MAX_EPOCH", "1",
            "SOLVER.NUM_IMAGE_PER_EPOCH", str(AMP_STEPS * b), "GLOBAL.LOG_INTERVAL", "1", "MODEL.WEIGHTS", weights,
            "GLOBAL.CKPT_SAVE_DIR", os.path.join(out_dir, f"{name.replace(' ', '_')}_amp_ckpt")]


def phase_amp_train(out_dir, name):
    """det_train --amp on full-width ``name``, AMP_STEPS steps of its config's batch, every kernel's
    and plain version's count zeroed just before and read just after: the launches per step of
    AMP_FAMILIES (the bf16 RoIAlign for Faster R-CNN, #9 on bf16 values for CenterNet), plain 0;
    finite losses. Then det_test serves the dump in f32 (DummyLoader's 8 requests). Faster R-CNN:
    the bf16 RoIAlign kernels held to their plain versions on the first step's own features and
    RoIs (the backward with a random bf16 g of the step's shape: the Function's g is not reachable
    from outside); returns their largest |kernel - plain|."""
    from basedet_tpu_torch.models import det
    from basedet_tpu_torch.ops import roi_align_kernel, scatter_rows_kernel
    from basedet_tpu_torch.tools import det_test, det_train

    config, batch, _, per_step = AMP_FAMILIES[name]
    path = f"{name} det_train --amp"
    cls = getattr(det, name.replace(" ", "").replace("-", ""))
    keep_losses = lambda args, out: {k: float(v.detach()) for k, v in out[1].items()}
    keep_first = lambda args, out: [a.detach().clone() if torch.is_tensor(a) else a for a in args]
    with recording(cls, "get_losses", keep_losses) as losses, \
            recording(scatter_rows_kernel, "scatter_rows", lambda args, out: args[1].dtype) as scatters, \
            recording(roi_align_kernel, "_launch_forward", keep_first) as roi_calls, \
            kernel_counts(path):
        t0 = time.perf_counter()
        trainer = det_train.main(["-f", config, "--device", "cuda", "--amp",
                                  *_amp_opts(out_dir, name, _amp_weights(out_dir, name))])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    steps = trainer.state.step
    check(steps == AMP_STEPS and len(losses) == AMP_STEPS, f"{path} took {steps} steps")
    counts = _new_counts(path, {k: n * steps for k, n in per_step.items()})
    check(all(math.isfinite(v) for step in losses for v in step.values()), f"non-finite {path} losses {losses}")
    check(len(scatters) == per_step.get("scatter_rows", 0) * steps and all(d == torch.bfloat16 for d in scatters),
          f"{path}: #9 took {len(scatters)} value tensors of {set(scatters)}, not bf16")
    dumped = os.path.join(out_dir, f"{name.replace(' ', '_')}_amp_ckpt", "dumped_model.pt")
    del trainer
    gc.collect()
    with kernel_counts(f"{name} det_test of the --amp run"):
        results = det_test.main(["-f", config, "-w", dumped, "--device", "cuda", *_amp_opts(out_dir, name),
                                 "TEST.CLS_THRESHOLD", "0.0"])
    check(results["num_detections"] > 0, f"{name}'s --amp dump served no detection")
    per = "; ".join(", ".join(f"{k.replace('_loss', '')} {v:.4f}" for k, v in step.items()) for step in losses)
    log(f"[amp-train] det_train --amp {name}, {steps} steps of {batch} images, bf16 policy, in {seconds:.2f} s; kernel "
        f"launches {counts}{f' (#9 on {len(scatters)} bf16 value tensors)' if scatters else ''}; losses per step: "
        f"{per}; det_test (f32) on its dump: {results['num_detections']} detections over 8 requests")
    if not roi_calls:
        return None
    feats, rois = roi_calls[0][:2]
    check(all(f.dtype == torch.bfloat16 for f in feats), f"{path}: the first step's RoIAlign took {feats[0].dtype}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    grad = torch.randn(*rois.shape[:2], 7, 7, feats[0].shape[1], device="cuda", generator=gen)
    return (_check_roi_align_bf16("train step's own", feats, rois),
            _check_roi_align_bwd_bf16("train step's RoIs", grad, rois))


def _amp_setup(name, weights, device, amp, batch=None, image=None, extra=()):
    """Full-width ``name`` in train mode with ``weights``, its train state and step (bf16 policy with
    ``amp``), and the first synthetic batch."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.data import DataloaderBuilder
    from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
    from basedet_tpu_torch.tools import import_config
    from basedet_tpu_torch.utils.registry import registers

    cfg = import_config(AMP_FAMILIES[name][0])
    cfg.merge([*_amp_opts(".", name, weights, batch, image), *extra, "TRAINER.AMP.ENABLE", str(bool(amp))])
    model = build_model(cfg, device)
    model.load_weights(weights)
    solver = registers.solvers.get(cfg.SOLVER.BUILDER_NAME).build(cfg)
    state = TrainState(model.train(), solver)
    return model, state, make_train_step(model, solver, cfg), next(DataloaderBuilder.build(cfg))


def phase_amp_timing(out_dir, name, card):
    """``name``'s train step in f32 and under the bf16 policy, the same weights and batch: events ms
    (mean of AMP_REPS), peak memory above what was held before the model was built, and the device's
    idle share (1 - the time at least one device operation runs over the span of the device work
    of the same AMP_REPS profiled steps, both on the profiler's clock). Returns {dtype: (ms, peak
    GiB, idle share)}."""
    out = {}
    for amp in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        model, state, step, batch = _amp_setup(name, _amp_weights(out_dir, name), "cuda", amp)
        step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(state, batch), reps=AMP_REPS, warmup=0)
        peak = (torch.cuda.max_memory_allocated() - before) / 2**30
        busy, union, span = device_busy_span(lambda: step(state, batch), AMP_REPS)
        check(0 < union <= span, f"{name}: the device busy {union:.3f} ms of a {span:.3f} ms span a step")
        out["bf16" if amp else "f32"] = (ms, peak, 1 - union / span, busy - union)
        del model, state, step, batch
    (f_ms, f_peak, f_idle, f_lap), (b_ms, b_peak, b_idle, b_lap) = out["f32"], out["bf16"]
    b, img = AMP_FAMILIES[name][1:3]
    log(f"[amp-timing] {name} train step, batch {b} of {img[0]}x{img[1]}: bf16 {b_ms:.3f} ms ({1000 * b / b_ms:.2f} "
        f"img/s), peak {b_peak:.2f} GiB, device idle share {b_idle:.3f}; f32 {f_ms:.3f} ms ({1000 * b / f_ms:.2f} img/s), "
        f"peak {f_peak:.2f} GiB, idle {f_idle:.3f}; bf16 at {b_ms / f_ms:.3f} of the f32 step (events, means of "
        f"{AMP_REPS}; idle share: the time no device operation runs over the span of {AMP_REPS} profiled steps' "
        f"device work; the operations' durations beyond that busy time, a step: bf16 {b_lap:.3f} ms, f32 "
        f"{f_lap:.3f} ms) | {card}")
    return {k: v[:3] for k, v in out.items()}


def _flat_grads(module):
    return {n: p.grad.detach().double().cpu() for n, p in module.named_parameters() if p.grad is not None}


def _cos(a, b):
    keys = sorted(b)
    x = torch.cat([a[k].flatten() for k in keys])
    y = torch.cat([b[k].flatten() for k in keys])
    return float(x @ y / (x.norm() * y.norm()))


def phase_amp_card_vs_cpu(out_dir, name, card):
    """One bf16 train pass of ``name`` on the card against one on the CPU, same weights and batch
    (AMP_GATES's batch of AMP_GATE_IMAGE; Faster R-CNN's sampling noise drawn once, copied), held with
    the CPU tests' yardstick (tests/test_torch_amp_families.py): each loss within 10% of the CPU's
    bf16 loss, the gradient norm within 15%, the gradient's cosine with the CPU's bf16 gradient at
    least half the CPU's bf16-vs-f32 cosine, which must itself be at least 0.5."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.layers.common.sampling import draw_sampling_noise
    from basedet_tpu_torch.layers.precision import precision_policy

    weights = _amp_weights(out_dir, name)
    b, eval_bn = AMP_GATES[name]
    h, w = AMP_GATE_IMAGE
    noise = None
    if name == "Faster R-CNN":
        anchors = 3 * sum(-(-h // s) * -(-w // s) for s in (4, 8, 16, 32, 64))
        noise = draw_sampling_noise(42, 0, b, anchors, FRCNN_CANDIDATES, "cpu")
    runs = {}
    setups = [("cpu", eval_bn, (None, torch.bfloat16)), ("cuda", eval_bn, (torch.bfloat16,))]
    if eval_bn:  # why not in train mode: the card's bf16 gradient against its f32 one there, reported
        setups.append(("cuda", False, (None, torch.bfloat16)))
    for device, eval_mode, dtypes in setups:
        model, _, _, batch = _amp_setup(name, weights, device, False, b, AMP_GATE_IMAGE)
        if eval_mode:
            model.module.eval()
        kw = {"noise": {k: t.to(device) for k, t in noise.items()}} if noise else {}
        for dtype in dtypes:
            model.module.zero_grad(set_to_none=True)
            with full_f32(), precision_policy(dtype):
                total, losses = model.get_losses(batch, **kw)
            with full_f32():
                total.backward()
            runs[device, eval_mode, dtype] = ({k: float(v.detach()) for k, v in losses.items()},
                                              _flat_grads(model.module))
        del model
    (cl, cg), (fl, fg), (gl, gg) = (runs["cpu", eval_bn, torch.bfloat16], runs["cpu", eval_bn, None],
                                    runs["cuda", eval_bn, torch.bfloat16])
    norm = lambda g: math.sqrt(sum(float((t ** 2).sum()) for t in g.values()))
    loss_ok = all(abs(gl[k] - cl[k]) <= 0.1 * abs(cl[k]) for k in cl)
    norm_ok = abs(norm(gg) - norm(cg)) <= 0.15 * norm(cg)
    cos, yard = _cos(gg, cg), _cos(fg, cg)
    train_mode = ""
    if eval_bn:
        tb, tf = runs["cuda", False, torch.bfloat16][1], runs["cuda", False, None][1]
        early = [k for k in tf if k.startswith(("bottom_up.conv1.", "bottom_up.layer1_"))]
        train_mode = (f"; in train mode on the card the bf16 gradient's cosine with the f32 one is {_cos(tb, tf):.4f}, "
                      f"the stem's and layer1's share of the f32 norm {norm({k: tf[k] for k in early}) ** 2 / norm(tf) ** 2:.3f}")
    log(f"[amp-gate] {name}, batch {b} of {h}x{w}{', BN in eval mode' if eval_bn else ''}, bf16 card | bf16 CPU: "
        "losses " + ", ".join(f"{k} {gl[k]:.4f} | {cl[k]:.4f} (CPU f32 {fl[k]:.4f})" for k in cl)
        + f"; gradient norm {norm(gg):.4f} | {norm(cg):.4f} (CPU f32 {norm(fg):.4f}); cosine with the CPU's bf16 "
        f"gradient {cos:.4f}, the CPU's bf16 against its f32 {yard:.4f}{train_mode} | {card}")
    check(yard >= 0.5, f"{name}: bf16 does not track f32 on this setup (cosine {yard:.4f}); the gate would be empty")
    check(loss_ok and norm_ok and cos >= 0.5 * yard, f"{name}: the card's bf16 pass is off the CPU's")


def phase_remat(out_dir, card):
    """TRAINER.REMAT on full-width YOLOv3 (f32, its config's batch of 8): one forward and backward
    each without REMAT, with True and with "selective", from the same weights and batch: losses and
    gradient norm equal within REMAT_RTOL, peak memory and time of each; kernel launches counted per
    pass (#10's two calls lie outside every segment, so twice a pass in each mode); then steps at
    batch 16 with REMAT True: peak (must fit the card) and step time."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.layers.remat import remat_policy

    weights = _amp_weights(out_dir, "YOLOv3")
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    model, _, _, batch = _amp_setup("YOLOv3", weights, "cuda", False)
    state = {k: v.clone() for k, v in model.module.state_dict().items()}
    runs = {}
    for mode in (None, "full", "selective"):
        model.module.load_state_dict(state)
        model.module.zero_grad(set_to_none=True)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        path = f"YOLOv3 REMAT {mode} pass"
        with kernel_counts(path):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            with full_f32(), remat_policy(mode):
                total, losses = model.get_losses(batch)
            with full_f32():
                total.backward()
            end.record()
            torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - before) / 2**30
        runs[mode] = ({k: float(v.detach()) for k, v in losses.items()}, _grad_norm(model.module), peak,
                      start.elapsed_time(end), check_counts(path, {"box_iou": YOLOV3_IOU_CALLS}))
        del total, losses
    plain = runs[None]
    for mode in ("full", "selective"):
        lo, g = runs[mode][:2]
        check(all(abs(lo[k] - v) <= REMAT_RTOL * abs(v) for k, v in plain[0].items())
              and abs(g - plain[1]) <= REMAT_RTOL * plain[1], f"REMAT {mode}: losses {lo} and norm {g} off {plain[:2]}")
    log(f"[remat] YOLOv3 f32, batch {YOLOV3_B} of {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]}, one forward + backward: "
        + "; ".join(f"{mode or 'no REMAT'}: peak {p:.2f} GiB, {ms:.1f} ms (one pass, events), total loss "
                    f"{lo['total_loss']:.6f}, gradient norm {g:.6f}, launches {c}"
                    for mode, (lo, g, p, ms, c) in runs.items())
        + f" (peaks above what was held before the model was built) | {card}")
    del model, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    model, st, step, batch = _amp_setup("YOLOv3", weights, "cuda", False, REMAT_B16, extra=["TRAINER.REMAT", "True"])
    check(batch["data"].shape[0] == REMAT_B16, f"a batch of {batch['data'].shape[0]}")
    step(st, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(st, batch), reps=2, warmup=0)
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    log(f"[remat] YOLOv3 f32 train step at batch {REMAT_B16} of {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} with TRAINER.REMAT "
        f"True: {ms:.1f} ms a step ({1000 * REMAT_B16 / ms:.2f} img/s, events, mean of 2), peak {peak:.2f} GiB of the "
        f"card's {total:.1f} | {card}")
    check(peak < total, "YOLOv3 at batch 16 with REMAT does not fit")
    del model, st, step, batch


def phase_amp_families(out_dir, card):
    """39-42. det_train --amp for the nine families (and det_test on each dump), each one's bf16 step
    beside its f32 step, the card-vs-CPU bf16 gate on RetinaNet, Faster R-CNN and CenterNet, and
    REMAT on YOLOv3. Returns the bf16 RoIAlign kernels' largest |kernel - plain| on Faster R-CNN's
    first --amp step's own arguments (forward, backward)."""
    errs = None
    for name in AMP_FAMILIES:
        gc.collect()
        torch.cuda.empty_cache()
        errs = phase_amp_train(out_dir, name) or errs
        phase_amp_timing(out_dir, name, card)
    for name in AMP_GATES:
        phase_amp_card_vs_cpu(out_dir, name, card)
    phase_remat(out_dir, card)
    return errs


# Data-parallel training (phases 43-44). Each phase launches `python -m torch.distributed.run` with this
# script as the worker (``--dp-worker``): every rank drives det_train --multi-host and writes its per-step
# losses and wall times, its kernel counts (zeroed just before the run, read just after), its gloo probes
# and its state_dict to a file under the phase's directory, which the phase reads.
DP_TIMEOUT = 420  # seconds for one torchrun launch, its ranks' start-up included
DP_GLOO_PROBES = ("all_reduce float32", "all_reduce float64", "all_reduce int64", "broadcast float32",
                  "all_gather float32", "reduce_scatter float32", "barrier")
# Two ranks against one process on the global batch, on every parameter and BN buffer after 2 steps:
# the JAX DP test's tolerance (tests/parallel/test_dp_equivalence.py), DP_RTOL and DP_ATOL, for Faster
# R-CNN (FrozenBN). Train-mode YOLOX-S with spread random weights does not hold it, and no run of it
# can: its gradients pass through BN backwards whose results are small differences of large terms (as
# CenterNet's, PERF.md §7), so any other order of the same sums moves them. Two ranks put the stem's
# weights 2.6e-5-3.1e-5 from one process's after 2 steps (16x DP_RTOL), tensor by tensor 1.4-6.8% of
# each tensor's own change; world size 1 over NCCL, where only the BN's sums change, up to 14% after 4
# steps with SimOTA's moved anchors; Faster R-CNN's largest deviation was 0.0099-0.040 of its
# tolerance (NVIDIA H100 80GB HBM3, 700.00 W). The BN buffers inherit it: the stem's running mean at
# step 2 is a mean of the stem's outputs at parameters that already differ (6.3x DP_RTOL). So YOLOX-S is
# held as a whole: its parameters' update over the steps, |two ranks' - one process's| / |one process's
# update| over all parameters, and its BN buffers' likewise, each to DP_UPDATE_RTOL (measured 0.0133 and
# 9.6e-7; at world size 1 over NCCL, with the moved anchors, 0.145 after 4 steps)
DP_RTOL, DP_ATOL, DP_UPDATE_RTOL = 1e-4, 1e-6, 0.1
# Each step's losses against one process's on the same batches. The first step starts from the same
# parameters and differs only in the order of sums (the cross-rank BN's float64 statistics against
# cuDNN's; the ranks' partial sums): measured 1.4e-6-1.5e-6. The second starts from parameters that
# differ by that (3.5e-5-3.7e-5). Then SimOTA's near-ties move a few of the ~10^2 foreground anchors:
# phase 43's steps 3-4 measured 1.8e-3-1.5e-2 off in three chip runs, while two runs of the plain
# det_train agreed to 1e-5 (NVIDIA H100 80GB HBM3, 700.00 W). Tolerances of steps 1, 2 and later:
DP_LOSS_RTOLS = (1e-4, 1e-3, 5e-2)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gloo_cuda_probes(device):
    """Which gloo collectives take CUDA tensors on this torch: each run once on this rank's card."""
    import torch.distributed as dist

    def run(name):
        op, dtype = (name.split() + ["float32"])[:2]
        t = torch.ones(8, dtype=getattr(torch, dtype), device=device)
        w = dist.get_world_size()
        if op == "all_reduce":
            dist.all_reduce(t)
            ok = bool((t == w).all())
        elif op == "broadcast":
            dist.broadcast(t, 0)
            ok = bool((t == 1).all())
        elif op == "all_gather":
            out = [torch.zeros_like(t) for _ in range(w)]
            dist.all_gather(out, t)
            ok = all(bool((o == 1).all()) for o in out)
        elif op == "reduce_scatter":
            out = torch.zeros_like(t)
            dist.reduce_scatter(out, [t.clone() for _ in range(w)])
            ok = bool((out == w).all())
        else:
            dist.barrier()
            ok = True
        torch.cuda.synchronize()
        return "ok" if ok else "wrong result"

    probes = {}
    for name in DP_GLOO_PROBES:
        try:
            probes[name] = run(name)
        except Exception as e:  # a collective the backend lacks for CUDA tensors: recorded, not fatal
            probes[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    return probes


def dp_worker(out_dir, tag, runs):
    """One rank under torchrun: for each (name, det_train arguments) of ``runs``, det_train (with
    --multi-host in its arguments) with the kernel counts zeroed just before and read just after,
    the cross-rank BN and gradient all-reduce calls counted, the model-group width of each of DETR's
    FFN calls recorded (phase 45), each step's wall time and global
    losses kept; then ``out_dir/<tag>_<name>_rank<r>.pt``. A second run takes its own port
    (``DP_SECOND_PORTS``), as det_train ends its process group."""
    from basedet_tpu_torch import parallel
    from basedet_tpu_torch.engine.trainer import DetTrainer
    from basedet_tpu_torch.layers.blocks import transformer
    from basedet_tpu_torch.layers.common import blocks
    from basedet_tpu_torch.parallel import tp
    from basedet_tpu_torch.tools import det_train

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this smoke test needs an NVIDIA GPU")
    rank = int(os.environ["RANK"])
    ports = os.environ.get("DP_SECOND_PORTS", "").split(",")
    probes = {}
    init = parallel.init_from_env

    def init_and_probe(device, backend=None):
        device = init(device, backend)
        if not probes and torch.distributed.get_backend() == "gloo":
            probes.update(_gloo_cuda_probes(device))
        return device

    parallel.init_from_env = init_and_probe
    for i, (name, args) in enumerate(runs):
        if i:  # a store of its own on a new port: torchrun's agent store serves the first group only
            os.environ["MASTER_PORT"] = ports[i - 1]
            os.environ["TORCHELASTIC_USE_AGENT_STORE"] = "False"
        steps, fn = [], DetTrainer.train_one_iter

        def one_iter(self, data_iter, fn=fn, steps=steps):
            t0 = time.perf_counter()
            fn(self, data_iter)  # GLOBAL.LOG_INTERVAL 1: it ends by reading the losses
            steps.append({"ms": (time.perf_counter() - t0 - self.meters["data_time"].latest) * 1e3,
                          "losses": {k: m.latest for k, m in self.meters.items() if "loss" in k}})

        path = f"{tag} {name} rank {rank}"
        if args == "csp_layer":  # phase 52's CSPLayer, under a process group of its own
            torch.save(dp_csp_layer(path), os.path.join(out_dir, f"{tag}_{name}_rank{rank}.pt"))
            continue
        DetTrainer.train_one_iter = one_iter
        try:
            with recording(blocks.CrossRankBatchNorm, "apply", lambda a, o: None) as bn_calls, \
                    recording(parallel, "all_reduce_grads", lambda a, o: None) as grad_reductions, \
                    recording(transformer, "reduce_from_model", lambda a, o: tp.tp_size()) as ffn_splits, \
                    kernel_counts(path):
                trainer = det_train.main(args)
                torch.cuda.synchronize()
        finally:
            DetTrainer.train_one_iter = fn
        torch.save({"steps": steps, "counts": DATA_COUNTS[path], "bn_calls": len(bn_calls),
                    "grad_reductions": len(grad_reductions), "ffn_splits": ffn_splits, "probes": dict(probes),
                    "world": trainer.world_size, "global_batch": trainer.global_batch_size,
                    "state": {k: v.detach().cpu() for k, v in trainer.model.module.state_dict().items()}},
                   os.path.join(out_dir, f"{tag}_{name}_rank{rank}.pt"))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()


def _torchrun(nproc, out_dir, tag, runs):
    """``runs`` ([(name, det_train arguments)]) under torchrun with ``nproc`` ranks on this card →
    {name: [rank 0's results, rank 1's, ...]}; its output into ``out_dir/<tag>.log``."""
    gc.collect()
    torch.cuda.empty_cache()
    env = {**os.environ, "DP_SECOND_PORTS": ",".join(str(_free_port()) for _ in runs[1:]), "OMP_NUM_THREADS": "2"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc), "--master-addr",
           "127.0.0.1", "--master-port", str(_free_port()), os.path.abspath(__file__), "--dp-worker", out_dir,
           "--dp-tag", tag, "--dp-runs", json.dumps(runs)]
    log_path = os.path.join(out_dir, f"{tag}.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, env=env, start_new_session=True)
        try:
            rc = proc.wait(timeout=DP_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait()
            rc = "timeout"
    seconds = time.perf_counter() - t0
    if rc != 0:
        with open(log_path) as f:
            log(f.read()[-8000:])
        check(False, f"torchrun {tag} exited {rc}")
    return {name: [torch.load(os.path.join(out_dir, f"{tag}_{name}_rank{r}.pt"), weights_only=False)
                   for r in range(nproc)] for name, _ in runs}, seconds


def _tp_args(out_dir, sub, multi_host):
    """det_train arguments of phase 45's DETR run, under ``out_dir/tp/sub``."""
    flags = ["--multi-host", "--dist-backend", "gloo"] if multi_host else []
    opts = _last_train_opts(os.path.join(out_dir, "tp", sub), "DETR", _amp_weights(out_dir, "DETR"), DETR_B)
    return ["-f", DETR_CONFIG, "--device", "cuda", *flags, *opts,
            *(["TRAINER.TP_SIZE", str(TP_SIZE)] if multi_host else [])]


def dp_launches(out_dir, weights, frcnn_weights):
    """The torchrun launches of phases 43-45 and 52, two in all (each launch pays its ranks'
    start-up): one rank over NCCL (phase 43's YOLOX-S, phase 52's fused chain) and two ranks sharing
    the card over gloo (phase 44's YOLOX-S and Faster R-CNN, phase 45's DETR at TP_SIZE 2, phase 52's
    CSPLayer and its fused and unfused YOLOX-S). → ((NCCL results, seconds), (gloo results, seconds))."""
    dp_dir = os.path.join(out_dir, "dp")
    for sub in ("dp_nccl", "dp_gloo", "tp", "fused_dp"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    at = lambda *parts: os.path.join(out_dir, *parts)
    os.makedirs(dp_dir, exist_ok=True)
    nccl = _torchrun(1, dp_dir, "nccl1", [
        ("yolox", _yolox_dp_args(at("dp_nccl", "dp"), weights, True, 8, 32)),
        ("fused", _fused_dp_args(at("fused_dp", "nccl"), weights, True, FUSED_DP_B))])
    gloo = _torchrun(2, dp_dir, "gloo2", [
        ("yolox", _yolox_dp_args(at("dp_gloo", "yolox"), weights, True, 4, 16, "gloo")),
        ("frcnn", _frcnn_dp_args(at("dp_gloo", "frcnn"), frcnn_weights, True, 1, 4, "gloo")),
        ("detr", _tp_args(out_dir, "tp", True)),
        ("csp", "csp_layer"),
        ("fused", _fused_dp_args(at("fused_dp", "fused"), weights, True, FUSED_DP_B // 2, "gloo")),
        ("unfused", _fused_dp_args(at("fused_dp", "unfused"), weights, True, FUSED_DP_B // 2, "gloo", fused=False))])
    return nccl, gloo


def _dp_plain(args, path):
    """The plain det_train (no process group) on ``args``, as the workers run it → (per step wall ms
    and losses, its state_dict on the CPU)."""
    from basedet_tpu_torch.engine.trainer import DetTrainer
    from basedet_tpu_torch.tools import det_train

    steps, fn = [], DetTrainer.train_one_iter

    def one_iter(self, data_iter):
        t0 = time.perf_counter()
        fn(self, data_iter)
        steps.append({"ms": (time.perf_counter() - t0 - self.meters["data_time"].latest) * 1e3,
                      "losses": {k: m.latest for k, m in self.meters.items() if "loss" in k}})

    DetTrainer.train_one_iter = one_iter
    try:
        with kernel_counts(path):
            trainer = det_train.main(args)
            torch.cuda.synchronize()
    finally:
        DetTrainer.train_one_iter = fn
    state = {k: v.detach().cpu() for k, v in trainer.model.module.state_dict().items()}
    del trainer
    return steps, state


def _median_ms(steps):
    """The median wall time of the steps after the first (which warms up), and a printable range."""
    ms = sorted(s["ms"] for s in steps[1:])
    return ms[len(ms) // 2], f"{ms[len(ms) // 2]:.1f} ms (range {ms[0]:.1f}-{ms[-1]:.1f}, steps 2-{len(steps)})"


def _check_losses(name, got, want):
    """Each step's losses against ``want``'s, held to DP_LOSS_RTOLS. Returns the largest relative
    error of each step."""
    worst = []
    for i, (g, w) in enumerate(zip(got, want)):
        check(g["losses"].keys() == w["losses"].keys(), f"{name} step {i + 1}: losses {sorted(g['losses'])}")
        rtol = DP_LOSS_RTOLS[min(i, len(DP_LOSS_RTOLS) - 1)]
        worst.append(0.0)
        for k, v in w["losses"].items():
            err = abs(g["losses"][k] - v) / max(abs(v), 1e-12)
            worst[-1] = max(worst[-1], err)
            check(math.isfinite(g["losses"][k]) and err <= rtol,
                  f"{name} step {i + 1}: {k} {g['losses'][k]!r} against {v!r} (rtol {rtol})")
    return "/".join(f"{e:.2e}" for e in worst)


def _yolox_dp_args(out_dir, weights, multi_host, per_rank, images, backend=None):
    opts = _train_opts(out_dir, weights)
    opts[opts.index("MODEL.BATCHSIZE") + 1] = str(per_rank)
    opts[opts.index("SOLVER.NUM_IMAGE_PER_EPOCH") + 1] = str(images)
    flags = (["--multi-host"] + (["--dist-backend", backend] if backend else [])) if multi_host else []
    return ["-f", CONFIG, "--device", "cuda", *flags, *opts]


def _frcnn_dp_args(out_dir, weights, multi_host, per_rank, images, backend=None):
    opts = _frcnn_train_opts(out_dir, weights)
    opts[opts.index("MODEL.BATCHSIZE") + 1] = str(per_rank)
    opts[opts.index("SOLVER.NUM_IMAGE_PER_EPOCH") + 1] = str(images)
    flags = (["--multi-host"] + (["--dist-backend", backend] if backend else [])) if multi_host else []
    return ["-f", FRCNN_CONFIG, "--device", "cuda", *flags, *opts]


def phase_dp_nccl(out_dir, weights, card, launched):
    """43. Data-parallel det_train at world size 1 over NCCL: full-width YOLOX-S, batch 8 of 640x640
    (resized to 832x832), f32 with TF32 off, 4 steps, through ``torchrun --nproc-per-node 1 ...
    det_train --multi-host``; under a process group the cross-rank BN and the gradient all-reduce
    run even at world size 1. Held to the plain det_train on the same batches (each step's losses,
    ``_check_losses``; the state after the 4 steps reported), timed beside it (median step wall time
    of steps 2-4 without the loader's batch, losses read each step); #2 and #10 once a step, plain 0.
    Returns {path: launches} of #2 and #10."""
    dp_dir = os.path.join(out_dir, "dp_nccl")
    os.makedirs(dp_dir, exist_ok=True)
    plain_path = "YOLOX-S det_train, plain beside the DP run"
    plain, plain_state = _dp_plain(_yolox_dp_args(os.path.join(dp_dir, "plain"), weights, False, 8, 32),
                                   plain_path)
    runs, seconds = launched
    res = runs["yolox"][0]
    check(res["world"] == 1 and res["global_batch"] == 8 and len(res["steps"]) == 4 == len(plain),
          f"the NCCL run took {len(res['steps'])} steps at world {res['world']}")
    check(res["bn_calls"] > 0 and res["grad_reductions"] == 4,
          f"the cross-rank BN ran {res['bn_calls']} times and the gradient all-reduce {res['grad_reductions']}")
    path = "YOLOX-S det_train --multi-host (NCCL, world size 1)"
    counts = res["counts"]
    for name, (launches, plain_calls) in counts.items():
        want = 4 if name in ("dynamic_k_matching", "box_iou") else 0
        check(launches == want and plain_calls == 0, f"{path}: {name} launched {launches} times, plain {plain_calls}")
    check_counts(plain_path, {"dynamic_k_matching": 4, "box_iou": 4})
    worst = _check_losses(path, res["steps"], plain)
    update = _update_deviation(res["state"], plain_state, torch.load(weights, map_location="cpu"))
    dp_ms, dp_text = _median_ms(res["steps"])
    plain_ms, plain_text = _median_ms(plain)
    log(f"[dp-nccl] {path}: 4 steps of 8 at 832x832 (a torchrun launch of {seconds:.1f} s with phase 52's NCCL run); cross-rank BN "
        f"calls {res['bn_calls']} ({res['bn_calls'] // 4} a step), gradient all-reduces {res['grad_reductions']}; "
        f"kernel launches #2 {counts['dynamic_k_matching'][0]}, #10 {counts['box_iou'][0]}, plain 0; losses "
        f"within {worst} relative of the plain det_train's, step by step (rtol {DP_LOSS_RTOLS[0]}, "
        f"{DP_LOSS_RTOLS[1]}, then "
        f"{DP_LOSS_RTOLS[-1]}); the parameters' update over the 4 steps {update:.4g} of its norm off the plain run's "
        f"(not held: SimOTA moved anchors at steps 3-4); step wall time without the loader's batch {dp_text} against "
        f"the plain step {plain_text}: {dp_ms / plain_ms:.3f}x | {card}")
    return {path: counts["dynamic_k_matching"][0]}, {path: counts["box_iou"][0]}


_BN_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _state_deviation(got, want, init):
    """[(the share used of DP_ATOL + DP_RTOL·|want|, name, largest |got - want|, largest |want|,
    largest change from ``init``)] of every floating tensor, the largest share first; integer
    tensors must be equal."""
    rows = []
    for k, w in want.items():
        g = got[k]
        if not w.is_floating_point():
            check(torch.equal(g, w), f"{k} differs")
            continue
        err = (g - w).abs()
        rows.append((float((err / (DP_ATOL + DP_RTOL * w.abs())).max()), k, float(err.max()),
                     float(w.abs().max()), float((w - init[k].to(w.dtype)).abs().max())))
    return sorted(rows, reverse=True)


def _update_deviation(got, want, init, buffers=False):
    """|got - want| / |want - init| over every parameter (with ``buffers``, over every floating BN
    buffer instead), in float64: how far the update over the steps lies from one process's, as a
    share of it."""
    keys = [k for k in want if k.endswith(_BN_BUFFERS) == buffers and want[k].is_floating_point()]
    diff = math.sqrt(sum(float(((got[k] - want[k]).double() ** 2).sum()) for k in keys))
    change = math.sqrt(sum(float(((want[k] - init[k].to(want[k].dtype)).double() ** 2).sum()) for k in keys))
    return diff / change


def _state_report(rows):
    return "; ".join(f"{k} {share:.3g} of it (|diff| {err:.3g}, max|value| {mag:.3g}, largest change {change:.3g})"
                     for share, k, err, mag, change in rows[:3])


def phase_dp_gloo(out_dir, weights, frcnn_weights, card, launched):
    """44. Two ranks sharing the card over gloo (``torchrun --nproc-per-node 2 ... --multi-host
    --dist-backend gloo``; not a multi-GPU figure): full-width YOLOX-S at 4 a rank against the plain
    det_train at 8, and Faster R-CNN R50-FPN at 1 a rank against 2 (the sampling draws and the
    RoIAlign kernels across ranks), 2 steps each. Rank 0's parameters and BN buffers to rtol 1e-4,
    atol 1e-6 of the plain run's (YOLOX-S: its update as a whole to DP_UPDATE_RTOL), both
    ranks' state_dicts bit-equal, each step's losses as ``_check_losses`` holds them; per rank #2
    and #10 once a step (YOLOX-S), RoIAlign forward, backward and NMS once a step and #10 twice
    (Faster R-CNN), plain 0; which gloo collectives take CUDA tensors; each step's wall time (the
    first warms up). Returns {kernel: {path: launches}}."""
    dp_dir = os.path.join(out_dir, "dp_gloo")
    os.makedirs(dp_dir, exist_ok=True)
    plain_yolox, yolox_state = _dp_plain(_yolox_dp_args(os.path.join(dp_dir, "plain_yolox"), weights, False, 8, 16),
                                         "YOLOX-S det_train, plain beside the 2-rank run")
    plain_frcnn, frcnn_state = _dp_plain(
        _frcnn_dp_args(os.path.join(dp_dir, "plain_frcnn"), frcnn_weights, False, 2, 4),
        "Faster R-CNN det_train, plain beside the 2-rank run")
    runs, seconds = launched
    expected = {"yolox": {"dynamic_k_matching": 2, "box_iou": 2},
                "frcnn": {"multilevel_roi_align": 2, "multilevel_roi_align_backward": 2, "nms_keep": 2, "box_iou": 4}}
    labels = {"yolox": "YOLOX-S det_train --multi-host, 2 ranks over gloo",
              "frcnn": "Faster R-CNN det_train --multi-host, 2 ranks over gloo"}
    launches, lines = {}, []
    inits = {"yolox": torch.load(weights, map_location="cpu"), "frcnn": torch.load(frcnn_weights, map_location="cpu")}
    for name, plain, state in (("yolox", plain_yolox, yolox_state), ("frcnn", plain_frcnn, frcnn_state)):
        ranks = runs[name]
        check(all(r["world"] == 2 and len(r["steps"]) == 2 for r in ranks), f"{name}: not 2 steps at world size 2")
        for k, v in ranks[0]["state"].items():
            check(torch.equal(v, ranks[1]["state"][k]), f"{labels[name]}: the ranks' {k} differ")
        for r, res in enumerate(ranks):
            for kernel, (n, plain_calls) in res["counts"].items():
                want = expected[name].get(kernel, 0)
                check(n == want and plain_calls == 0, f"{labels[name]} rank {r}: {kernel} launched {n} times, "
                                                      f"not {want}; plain {plain_calls}")
                if n:
                    launches.setdefault(kernel, {})[f"{labels[name]} (rank {r})"] = n
        update = _update_deviation(ranks[0]["state"], state, inits[name])
        rows = _state_deviation(ranks[0]["state"], state, inits[name])
        if name == "yolox":  # see DP_UPDATE_RTOL: held as a whole
            buffers = _update_deviation(ranks[0]["state"], state, inits[name], buffers=True)
            check(update <= DP_UPDATE_RTOL and buffers <= DP_UPDATE_RTOL,
                  f"{labels[name]}: the update of its parameters {update:.4g} and of its BN buffers {buffers:.4g} "
                  f"of its norm off one process's (DP_UPDATE_RTOL {DP_UPDATE_RTOL}); most off: {_state_report(rows)}")
            held = (f"the update of its parameters {update:.4g} and of its BN buffers {buffers:.4g} of its norm off "
                    f"one process's (DP_UPDATE_RTOL {DP_UPDATE_RTOL}); per tensor, against rtol {DP_RTOL}, atol "
                    f"{DP_ATOL} (not held): {_state_report(rows)}")
        else:
            check(rows[0][0] <= 1, f"{labels[name]}: rank 0's state off by more than rtol {DP_RTOL}, atol {DP_ATOL}: "
                                   f"{_state_report(rows)}")
            held = (f"every tensor within rtol {DP_RTOL}, atol {DP_ATOL} ({_state_report(rows)}); the update of its "
                    f"parameters {update:.4g} of its norm off one process's")
        worst_loss = _check_losses(labels[name], ranks[0]["steps"], plain)
        check(ranks[0]["bn_calls"] > 0 or name == "frcnn", f"{name}: the cross-rank BN never ran")
        ms = lambda steps: "/".join(f"{s['ms']:.1f}" for s in steps)
        lines.append(f"{labels[name]}: rank 0's state: {held}; the ranks bit-equal, losses within "
                     f"{worst_loss} relative by step; per rank launches "
                     f"{', '.join(f'{k} {v[0]}' for k, v in ranks[0]['counts'].items() if v[0])}, plain 0; cross-rank "
                     f"BN calls {ranks[0]['bn_calls']}; step wall time without the loader's batch, steps 1/2: rank 0 "
                     f"{ms(ranks[0]['steps'])} ms, rank 1 {ms(ranks[1]['steps'])} ms, against the plain step at the "
                     f"global batch {ms(plain)} ms")
    probes = runs["yolox"][0]["probes"]
    log(f"[dp-gloo] two ranks sharing the card over gloo (a torchrun launch of {seconds:.1f} s with phases 45 and 52's runs, YOLOX-S 2 steps of "
        f"4 a rank at 832x832, Faster R-CNN 2 steps of 1 a rank at 800x1333): " + "; ".join(lines)
        + f"; gloo collectives on CUDA tensors: {probes} | {card}")
    return launches


# -- tensor parallelism (TRAINER.TP_SIZE) and the tools: trace, profile, analyze -------------------

TP_SIZE = 2
# The two TP ranks against one process on the same weights and batches: the two differ in the order of
# the FFN's sums (two partial products of 1024 hidden columns, summed over gloo, against one product of
# 2048) and in cuDNN's non-deterministic weight gradients (which the model group's average makes the
# ranks share). The losses are held as the data-parallel runs' (DP_LOSS_RTOLS; measured 1.0e-7 and
# 2.0e-7). The state is held as a whole, the parameters' update over the 2 steps within TP_UPDATE_RTOL of
# its norm (measured 3.2e-4), and reported tensor by tensor against DP_RTOL, DP_ATOL, which it does not
# hold: AdamW moves an element by about the LR whatever its gradient's size, so an element whose gradient
# is near 0 takes the sign of the rounding (encoder_4.linear1.weight 1.21e-5 off, one step's LR of
# 1.25e-5, at 3.3x that tolerance; NVIDIA H100 80GB HBM3, 700.00 W)
TP_UPDATE_RTOL = 1e-2
EXPORT_RTOL = 1e-5  # a reloaded program against the eager module, of max(1, max|output|): the same ATen ops
ANALYZE = {  # family: (config, image the phases run it at)
    "YOLOX-S": (CONFIG, (640, 640)), "Faster R-CNN": (FRCNN_CONFIG, (800, 1344)),
    "CenterNet": (CNET_CONFIG, CNET_IMAGE), "RetinaNet": (RETINA_CONFIG, (800, 1344)),
    **{name: (NEW_MODELS[name][0], (800, 1344)) for name in ("FCOS", "ATSS", "OTA", "FreeAnchor")},
    "YOLOv3": (YOLOV3_CONFIG, (800, 1344)), "DETR": (DETR_CONFIG, (800, 1344)),
}


def phase_tp(out_dir, card, launched):
    """45. Tensor parallelism: full-width DETR R50 (6 + 6 layers, FFN 2048, 100 queries), 2 steps of 2
    images of 800x1333, dropout 0.1, through ``torchrun --nproc-per-node 2 ... det_train --multi-host
    --dist-backend gloo TRAINER.TP_SIZE 2`` (data 1 x model 2: both ranks share the card and step the
    same rows, each FFN split over them) against the plain det_train on the same weights and batches:
    each step's losses, the state after the steps, the ranks bit-equal, every FFN call of the ranks
    split two ways, no kernel launched (DETR runs none) and no plain version; the step wall time beside
    the plain step's. NCCL at TP_SIZE 2 needs two cards: not run here."""
    weights = _amp_weights(out_dir, "DETR")
    plain, state = _dp_plain(_tp_args(out_dir, "plain", False), "DETR det_train, plain beside the TP run")
    runs, seconds = launched
    ranks = runs["detr"]
    label = f"DETR det_train --multi-host TRAINER.TP_SIZE {TP_SIZE}, 2 ranks over gloo"
    layers = 6 + 6
    for r, res in enumerate(ranks):
        check(res["world"] == 1 and res["global_batch"] == DETR_B and len(res["steps"]) == LAST_STEPS,
              f"{label} rank {r}: {len(res['steps'])} steps at data-parallel world {res['world']}, global batch "
              f"{res['global_batch']}")
        check(res["ffn_splits"] == [TP_SIZE] * (layers * LAST_STEPS),
              f"{label} rank {r}: FFN calls split {res['ffn_splits']}")
        for kernel, (n, plain_calls) in res["counts"].items():
            check(n == 0 and plain_calls == 0, f"{label} rank {r}: {kernel} launched {n} times, plain {plain_calls}")
    for k, v in ranks[0]["state"].items():
        check(torch.equal(v, ranks[1]["state"][k]), f"{label}: the ranks' {k} differ")
    init = torch.load(weights, map_location="cpu")
    worst_loss = _check_losses(label, ranks[0]["steps"], plain)
    update = _update_deviation(ranks[0]["state"], state, init)
    rows = _state_deviation(ranks[0]["state"], state, init)
    check(update <= TP_UPDATE_RTOL, f"{label}: the update of its parameters {update:.4g} of its norm off one "
                                    f"process's (TP_UPDATE_RTOL {TP_UPDATE_RTOL}); most off: {_state_report(rows)}")
    tp_ms, tp_text = _median_ms(ranks[0]["steps"])
    plain_ms, plain_text = _median_ms(plain)
    ms = lambda steps: "/".join(f"{s['ms']:.1f}" for s in steps)
    log(f"[tp] {label} (data 1 x model {TP_SIZE}, in phase 44's torchrun launch; 2 steps of {DETR_B} at "
        f"{FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]}, dropout 0.1): every one of the {layers} FFN calls a step split "
        f"{TP_SIZE} ways on each rank; the ranks bit-equal; losses within {worst_loss} relative of the plain "
        f"det_train's by step; the update of its parameters {update:.4g} of its norm off one process's "
        f"(TP_UPDATE_RTOL {TP_UPDATE_RTOL}); per tensor, against rtol {DP_RTOL}, atol {DP_ATOL}"
        f"{' (held)' if rows[0][0] <= 1 else ' (not held)'}: {_state_report(rows)}; no kernel launch, plain 0; step "
        f"wall time, steps 1/2: rank 0 {ms(ranks[0]['steps'])} ms, rank 1 {ms(ranks[1]['steps'])} ms, plain "
        f"{ms(plain)} ms; step 2: {tp_text} against {plain_text}, {tp_ms / plain_ms:.3f}x | {card}")


def kernel_launches(fn, iters, names):
    """Launches per call of fn of the device kernels whose names contain each of ``names``, from
    torch.profiler (``profiled``: a pass must show every name)."""

    def read(prof):
        ops = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        found = {n: sum(e.count for e in ops if n in e.key) for n in names}
        return {n: c / iters for n, c in found.items()} if all(found.values()) else None

    return profiled(fn, iters, read, f"kernels named {names}")


def _flat_tensors(out):
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _flat_tensors(out[k])]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat_tensors(o)]
    return [out]


def _compare_outputs(what, got, want):
    """Continuous outputs within EXPORT_RTOL of max(1, max|want|), discrete (bool, integer) equal.
    Returns the largest error, printable."""
    got, want = _flat_tensors(got), _flat_tensors(want)
    check(len(got) == len(want), f"{what}: {len(got)} outputs against {len(want)}")
    worst = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype, f"{what}: {g.dtype} {tuple(g.shape)} against {w.dtype} "
                                                         f"{tuple(w.shape)}")
        if not w.is_floating_point():
            check(torch.equal(g, w), f"{what}: a discrete output differs")
            continue
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite outputs")
        err = float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
        check(err <= EXPORT_RTOL, f"{what}: off by {err:.3g} of max(1, max|output|) (EXPORT_RTOL {EXPORT_RTOL})")
        worst = max(worst, err)
    return f"{worst:.3g}"


def phase_trace(out_dir, weights, frcnn_weights, card):
    """46. trace_net (``torch.export``) on full-width YOLOX-S at 640x640 and Faster R-CNN R50-FPN at
    800x1344, each with the earlier phases' random weights (``-w``); each program reloaded
    (``load_static_graph``) and run on a seeded image beside the eager module: outputs within
    EXPORT_RTOL, discrete outputs equal, the detections of post_process on both equal; Faster R-CNN's
    program holds NMS and RoIAlign as one custom-op node each and launches their kernels (the
    profiler's count by kernel name, and the wrappers' counts) as often as the eager module does, its
    plain versions never. Export and reload times printed."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.models.base_net import load_static_graph
    from basedet_tpu_torch.tools import import_config, trace_net
    from basedet_tpu_torch.utils.dummy import DummyLoader

    for name, config, w, image, size in (("YOLOX-S", CONFIG, weights, (640, 640), (640, 640)),
                                         ("Faster R-CNN", FRCNN_CONFIG, frcnn_weights, FRCNN_IMAGE, (800, 1344))):
        gc.collect()
        torch.cuda.empty_cache()
        path = os.path.join(out_dir, f"{name.replace(' ', '_').lower()}.pt2")
        t0 = time.perf_counter()
        program = trace_net.main(["-f", config, "-w", w, "--device", "cuda", "--height", str(size[0]), "--width",
                                  str(size[1]), "--out", path, "GLOBAL.OUTPUT_DIR", out_dir])
        export_s = time.perf_counter() - t0
        ops = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        custom = {op: ops.count(op) for op in sorted(set(ops)) if op.startswith("basedet.")}
        want_custom = {"basedet.nms_keep.default": 1, "basedet.roi_align.default": 1} if name == "Faster R-CNN" else {}
        check(custom == want_custom, f"{name}'s program calls the custom ops {custom}, not {want_custom}")
        del program
        t0 = time.perf_counter()
        reloaded = load_static_graph(path)
        load_s = time.perf_counter() - t0
        cfg = import_config(config)
        cfg.merge(["DATA.TEST.name", "dummy", "GLOBAL.OUTPUT_DIR", out_dir])
        model = build_model(cfg, "cuda")
        model.load_weights(w)
        model.eval()
        batch = DummyLoader(batch_size=1, image_size=image, max_instances=cfg.DATA.MAX_INSTANCES).make_batch()
        inputs = model.pre_process(batch)
        check(tuple(inputs["image"].shape[2:]) == size, f"{name}: the image pads to {tuple(inputs['image'].shape)}")
        args = (inputs["image"], inputs["img_info"]) if name == "Faster R-CNN" else (inputs["image"],)
        outputs, counts = {}, {}
        for tag, fn in (("eager module", model.module), ("exported program, reloaded", reloaded)):
            path_name = f"{name} {tag} (trace_net)"
            with torch.no_grad(), kernel_counts(path_name):
                out = fn(*args)
                dets = model.post_process(*out, inputs["img_info"])
                torch.cuda.synchronize()
            outputs[tag] = (out, dets)
            counts[tag] = {k: v for k, v in DATA_COUNTS[path_name].items() if v != (0, 0)}
        err = _compare_outputs(f"{name}'s reloaded program", outputs["exported program, reloaded"][0],
                               outputs["eager module"][0])
        det_err = _compare_outputs(f"{name}'s detections from the reloaded program",
                                   outputs["exported program, reloaded"][1], outputs["eager module"][1])
        check(counts["exported program, reloaded"] == counts["eager module"],
              f"{name}: launches {counts['exported program, reloaded']} reloaded, {counts['eager module']} eager")
        check(all(plain == 0 for _, plain in counts["eager module"].values()), f"{name}: a plain version ran")
        extra = ""
        if name == "Faster R-CNN":
            check(counts["eager module"].get("nms_keep") == (2, 0) and
                  counts["eager module"].get("multilevel_roi_align") == (1, 0),
                  f"Faster R-CNN's request launched {counts['eager module']}")
            names = ("nms_mask_kernel", "nms_sweep_kernel", "roi_align_fwd_kernel")
            with torch.no_grad():
                profiled_counts = {tag: kernel_launches(lambda fn=fn: fn(*args), 3, names)
                                   for tag, fn in (("eager", model.module), ("reloaded", reloaded))}
            check(profiled_counts["eager"] == profiled_counts["reloaded"],
                  f"Faster R-CNN's kernels by the profiler: {profiled_counts}")
            extra = f"; the profiler's launches a forward, eager | reloaded: {profiled_counts}"
        log(f"[trace] {name} at {size[0]}x{size[1]}: torch.export and save in {export_s:.1f} s, reload in "
            f"{load_s:.1f} s; custom-op nodes {custom or 'none'}; the reloaded program's outputs within {err} of "
            f"max(1, max|output|) of the eager module's (EXPORT_RTOL {EXPORT_RTOL}), discrete outputs equal; its "
            f"detections (post_process, NMS included) within {det_err}, labels and validity equal; kernel launches "
            f"and plain calls of the forward and post_process, eager | reloaded: {counts['eager module']} | "
            f"{counts['exported program, reloaded']}{extra} | {card}")
        del reloaded, model, outputs


def phase_profile_tool(out_dir, card):
    """47. profile_net on full-width YOLOX-S training, batch 8 of 640x640 (DummyLoader's, random weights
    from seed 0), 3 steps traced after a warm one: the Chrome trace parses as JSON and holds kernels #2
    (``match_kernel``) and #10 (``iou_kernel``) once a step; the wrappers launch them 4 times (with
    the warm step), the plain versions never."""
    from basedet_tpu_torch.tools import profile_net

    trace_dir = os.path.join(out_dir, "profile_net")
    path_name = "YOLOX-S profile_net (warm step + 3 traced)"
    t0 = time.perf_counter()
    with kernel_counts(path_name):
        trace = profile_net.main(["-f", CONFIG, "--device", "cuda", "--iters", "3", "--trace-dir", trace_dir,
                                  "MODEL.BATCHSIZE", "8", "DATA.DUMMY_IMAGE_SIZE", "(640,640)",
                                  "GLOBAL.OUTPUT_DIR", trace_dir])
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = check_counts(path_name, {"dynamic_k_matching": 4, "box_iou": 4})
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    found = {n: sum(n in e.get("name", "") for e in kernels) for n in ("match_kernel", "iou_kernel")}
    check(found == {"match_kernel": 3, "iou_kernel": 3}, f"profile_net's trace holds {found} of #2 and #10")
    busy = sum(e.get("dur", 0) for e in kernels) / 1e3 / 3
    log(f"[profile] profile_net YOLOX-S train, batch 8 of 640x640, 3 steps traced: {trace} parses, "
        f"{len(events)} events, {len(kernels)} kernel events ({len(kernels) / 3:.0f} a step, their durations "
        f"{busy:.3f} ms a step), #2 and #10 once a step; wrappers' launches with the warm step {counts}; "
        f"the tool's run {seconds:.1f} s | {card}")


def phase_analyze(card):
    """48. analyze_net on each of the ten families' configs at the image the phases run them at:
    parameters (the JAX package's ``params`` collection; the CPU tests hold it to the JAX tool) and
    FlopCounterMode's forward GFLOPs (convolutions and matrix products)."""
    from basedet_tpu_torch.tools import analyze_net, import_config

    rows = []
    t0 = time.perf_counter()
    for name, (config, size) in ANALYZE.items():
        gc.collect()
        torch.cuda.empty_cache()
        stats = analyze_net.analyze(import_config(config), size, "cuda")
        check(stats["params"] > 0 and stats["forward_gflops"] > 0 and math.isfinite(stats["forward_gflops"]),
              f"analyze_net {name}: {stats}")
        rows.append(f"{name} {stats['params']} parameters ({stats['params_M']} M), {stats['forward_gflops']} GFLOPs "
                    f"at {size[0]}x{size[1]}")
    log(f"[analyze] analyze_net over the ten families in {time.perf_counter() - t0:.1f} s: " + "; ".join(rows)
        + f" | {card}")


# -- phase 49: YOLOX-M over a long run's machinery: TensorBoard, async checkpoints, the native matcher, --debug ---

YOLOX_M_CONFIG = "basedet_tpu_torch/playground/yolox_m/config.py"
YOLOX_M_STEPS = 10  # iterations per epoch: TensorboardHook writes every 20 steps, so 2 epochs give one write
YOLOX_M_REPS = 5
EVAL_IMAGES, EVAL_CLASSES = 500, 80  # the COCO-like evaluation the native matcher is timed on


def make_yolox_m_weights(out_dir):
    """Full-width YOLOX-M (3 classes, the synthetic set's) on the card with random weights from SEED,
    spread by ``randomise``, saved as a state_dict. Returns (cfg for det_test, model, path)."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.tools import import_config

    cfg = import_config(YOLOX_M_CONFIG)
    cfg.merge(["DATA.NUM_CLASSES", "3", "DATA.TEST.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", "(640,640)",
               "GLOBAL.OUTPUT_DIR", out_dir])
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    model = build_model(cfg, "cuda", generator)
    randomise(model.module, generator)
    weights = os.path.join(out_dir, "yolox_m_seed0.pt")
    torch.save(model.module.state_dict(), weights)
    return cfg, model, weights


def _yolox_m_args(run_dir, weights, epochs, flags=(), extra=()):
    workers = str(min(8, os.cpu_count() or 1))
    return ["-f", YOLOX_M_CONFIG, "--device", "cuda", "--tb", *flags,
            "DATA.TRAIN.name", "smoke_synth_train", "DATA.TEST.name", "smoke_synth_val", "DATA.NUM_CLASSES", "3",
            "DATA.NUM_WORKERS", workers, "MODEL.BATCHSIZE", "8", "SOLVER.MAX_EPOCH", str(epochs),
            "SOLVER.NUM_IMAGE_PER_EPOCH", str(8 * YOLOX_M_STEPS), "GLOBAL.LOG_INTERVAL", "1",
            "GLOBAL.TENSORBOARD.LOG_IMAGES", "True", "GLOBAL.CKPT_BACKEND", "orbax", "TEST.EVAL_EPOCH_INTERVAL", "1",
            "MODEL.WEIGHTS", weights, "GLOBAL.OUTPUT_DIR", run_dir, "GLOBAL.CKPT_SAVE_DIR",
            os.path.join(run_dir, "ckpt"), *extra]


def _evals(trainer, epochs):
    """EvalHook's evaluations in a run of ``epochs`` epochs (every epoch but the last, then the live and
    the EMA weights after training)."""
    return (epochs - 1) + 1 + int(trainer.ema_enabled)


@contextlib.contextmanager
def _hook_times(cls, name):
    """Host seconds of each call of ``cls.name`` in the body."""
    fn, times = getattr(cls, name), []

    def wrapper(self, *args):
        t0 = time.perf_counter()
        out = fn(self, *args)
        times.append(time.perf_counter() - t0)
        return out

    setattr(cls, name, wrapper)
    try:
        yield times
    finally:
        setattr(cls, name, fn)


def _check_events(tb_dir, epochs, canvas_sizes):
    """The run's event files parse with the script's own reader (every CRC checked): the version event
    first in each file, the meters' scalars at step 20, and per epoch two detection images whose PNG
    decodes with Pillow to the last batch's canvas. Returns a summary."""
    import glob
    import io

    from PIL import Image

    from basedet_tpu_torch.utils.tb_writer import read_events

    paths = sorted(glob.glob(os.path.join(tb_dir, "events.out.tfevents.*")))
    check(len(paths) == 2, f"{tb_dir} holds {len(paths)} event files, not 2 (scalars, images)")
    scalars, images = {}, {}
    for path in paths:
        events = read_events(path)
        check(events[0].get("file_version") == "brain.Event:2", f"{path}: no version event first")
        for e in events[1:]:
            for v in e["values"]:
                if "simple_value" in v:
                    scalars.setdefault(v["tag"], []).append((e["step"], v["simple_value"]))
                else:
                    images.setdefault(v["tag"], []).append((e["step"], v["image"]))
    check({"total_loss", "lr", "data_time"} <= set(scalars) and all(
        [s for s, _ in series] == [2 * YOLOX_M_STEPS] for series in scalars.values()),
        f"scalars {sorted(scalars)} at steps {[[s for s, _ in v] for v in scalars.values()][:3]}")
    check(all(math.isfinite(v) for series in scalars.values() for _, v in series), "non-finite scalars")
    check(sorted(images) == ["detections/img0", "detections/img1"], f"image tags {sorted(images)}")
    for tag, series in images.items():
        check([s for s, _ in series] == [YOLOX_M_STEPS * e for e in range(1, epochs + 1)], f"{tag} at "
              f"{[s for s, _ in series]}")
        for (step, img), size in zip(series, canvas_sizes):
            pixels = np.asarray(Image.open(io.BytesIO(img["png"])))
            check(pixels.shape == (size, size, 3) == (img["height"], img["width"], img["colorspace"]),
                  f"{tag} step {step}: a {pixels.shape} PNG for a {size}x{size} canvas")
    return (f"{len(paths)} event files, {sum(len(v) for v in scalars.values())} scalars ({len(scalars)} tags at step "
            f"{2 * YOLOX_M_STEPS}), {sum(len(v) for v in images.values())} PNG images decoded by Pillow, every "
            f"CRC-32C checked")


def _coco_like_records(rng):
    """EVAL_IMAGES COCO-like images: 1-14 gts each over EVAL_CLASSES classes, 100 detections each
    (jittered copies of gts and random boxes, scores uniform), as {(image, class): [records]}."""
    gt_by, dt_by = {}, {}
    for img in range(EVAL_IMAGES):
        n = int(rng.randint(1, 15))
        xy, wh = rng.uniform(0, 500, (n, 2)), rng.uniform(4, 200, (n, 2))
        labels = rng.randint(1, EVAL_CLASSES + 1, n)
        for box, label in zip(np.concatenate([xy, wh], 1), labels):
            gt_by.setdefault((img, int(label)), []).append(
                dict(bbox=list(box), area=float(box[2] * box[3]), iscrowd=int(rng.uniform() < 0.02)))
        src = rng.randint(0, n, 100)
        boxes = np.concatenate([xy, wh], 1)[src] + rng.normal(0, 8, (100, 4)) * [1, 1, 0.5, 0.5]
        boxes[50:] = np.concatenate([rng.uniform(0, 500, (50, 2)), rng.uniform(4, 200, (50, 2))], 1)
        boxes[:, 2:] = np.abs(boxes[:, 2:]) + 1
        det_labels = np.where(np.arange(100) < 50, labels[src], rng.randint(1, EVAL_CLASSES + 1, 100))
        for box, label, score in zip(boxes, det_labels, rng.uniform(0, 1, 100)):
            dt_by.setdefault((img, int(label)), []).append(dict(bbox=list(box), score=float(score)))
    return gt_by, dt_by, list(range(EVAL_IMAGES)), list(range(1, EVAL_CLASSES + 1))


def phase_yolox_m_eval(out_dir, ckpt, card):
    """det_test of YOLOX-M's last async checkpoint on the 40 val images; the AP through the native
    matcher must equal the AP through ``_match_python`` on the same detections, every metric. Then
    both timed on those detections and on a COCO-like evaluation of EVAL_IMAGES images."""
    from basedet_tpu_torch.data import build_test_dataloader
    from basedet_tpu_torch.evaluators.coco_eval import COCOEvaluator
    from basedet_tpu_torch.evaluators.coco_metrics import _match_python, evaluate_coco_map
    from basedet_tpu_torch.tools import det_test, import_config

    run_dir = os.path.join(out_dir, "yolox_m_test")
    opts = ["DATA.TEST.name", "smoke_synth_val", "DATA.NUM_CLASSES", "3", "GLOBAL.OUTPUT_DIR", run_dir]
    with kernel_counts("YOLOX-M det_test, synthetic set"):
        results = det_test.main(["-f", YOLOX_M_CONFIG, "-w", ckpt, "--device", "cuda", *opts])
    counts = check_counts("YOLOX-M det_test, synthetic set", {"nms_keep": DATA_VAL})
    cfg = import_config(YOLOX_M_CONFIG)
    cfg.merge(opts)
    dataset = build_test_dataloader(cfg).dataset
    with open(os.path.join(run_dir, "predict_coco.json")) as f:
        records = json.load(f)
    evaluator = COCOEvaluator(cfg)
    times = {}
    for name, match in (("native", None), ("python", _match_python)):
        t0 = time.perf_counter()
        times[name] = evaluator.evaluate_records(records, dataset, match)
        times[name + "_s"] = time.perf_counter() - t0
    check(times["native"] == times["python"] == results, f"the native matcher's metrics {times['native']} differ "
          f"from the Python matcher's {times['python']} or det_test's {results}")
    args = _coco_like_records(np.random.RandomState(SEED))
    big = {}
    for name, match in (("native", None), ("python", _match_python), ("native again", None)):
        t0 = time.perf_counter()
        big[name] = evaluate_coco_map(*args, match=match)
        big[name + "_s"] = time.perf_counter() - t0
    check(big["native"] == big["python"] == big["native again"], "the COCO-like evaluation's metrics differ between "
                                                                 "the native and the Python matcher")
    log(f"[yolox-m-eval] det_test YOLOX-M, the async checkpoint {os.path.basename(ckpt)}, {DATA_VAL} val requests: "
        f"AP {results['AP']:.4f}, AP50 {results['AP50']:.4f}; kernel launches {counts}; all 12 metrics equal through "
        f"the native matcher and _match_python; evaluate_records on its {len(records)} detections: native "
        f"{times['native_s']:.3f} s, Python {times['python_s']:.3f} s | {card}")
    log(f"[yolox-m-eval] COCO evaluation of {EVAL_IMAGES} COCO-like images ({EVAL_CLASSES} classes, 1-14 gts and 100 "
        f"detections each) on the host, os.cpu_count() {os.cpu_count()}: native matcher "
        f"{big['native_s']:.3f} s and {big['native again_s']:.3f} s, Python matcher {big['python_s']:.3f} s "
        f"({big['python_s'] / big['native again_s']:.2f}x); AP {big['native']['AP']:.4f} in all three | {card}")


def phase_yolox_m_train(out_dir, weights, card):
    """det_train on full-width YOLOX-M over the synthetic set with --tb, LOG_IMAGES, async checkpoints
    and an evaluation every epoch: 2 epochs of YOLOX_M_STEPS steps of 8 (640x640, then the multiscale
    resize); a truncated 3.pt.tmp dropped into the checkpoint directory; --resume to a third epoch,
    which must restore epoch 2's file and go on at epoch 3. Kernel counts per run; the event files
    parse; the loop's block at an epoch end, async against the pickle hook on the same state. Returns
    the checkpoint of epoch 3."""
    from basedet_tpu_torch.engine.hooks import AsyncCheckpointHook, CheckpointHook
    from basedet_tpu_torch.models.det.yolox import YOLOX
    from basedet_tpu_torch.tools import det_train

    run_dir = os.path.join(out_dir, "yolox_m")
    ckpt_dir = os.path.join(run_dir, "ckpt")
    sizes = []
    keep_size = lambda args, out: out["data"].shape[1]
    path = "YOLOX-M det_train --tb, async checkpoints, synthetic set"
    with kernel_counts(path), recording(YOLOX, "train_batch_mapper", keep_size) as sizes, \
            _hook_times(AsyncCheckpointHook, "after_epoch") as blocked, \
            _hook_times(AsyncCheckpointHook, "_write") as written:
        t0 = time.perf_counter()
        trainer = det_train.main(_yolox_m_args(run_dir, weights, 2))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    steps = trainer.state.step
    check(steps == 2 * YOLOX_M_STEPS, f"det_train YOLOX-M took {steps} steps")
    counts = check_counts(path, {"dynamic_k_matching": steps, "box_iou": steps,
                                 "nms_keep": _evals(trainer, 2) * DATA_VAL + 2})
    check(sorted(os.listdir(ckpt_dir)) == ["1.pt", "2.pt"], f"async checkpoints {sorted(os.listdir(ckpt_dir))}")
    check(all(math.isfinite(m.latest) for k, m in trainer.meters.items() if "loss" in k), "non-finite losses")
    events = _check_events(os.path.join(run_dir, "tb"), 2, [sizes[YOLOX_M_STEPS - 1], sizes[-1]])
    log(f"[yolox-m-train] det_train YOLOX-M (25.3 M parameters), {steps} steps of 8 images of 640x640 "
        f"(multiscale sizes {sorted(set(sizes))}), --tb with LOG_IMAGES, CKPT_BACKEND orbax, an evaluation every "
        f"epoch, in {seconds:.2f} s; kernel launches {counts}; {events}; the async hook's after_epoch "
        f"{', '.join(f'{1000 * t:.1f}' for t in blocked)} ms, its writes {', '.join(f'{t:.2f}' for t in written)} s "
        f"on the writer thread | {card}")

    # the loop's block at an epoch end on this state: the async hook against the pickle one, in turns
    hooks = {"async": AsyncCheckpointHook(os.path.join(out_dir, "block_async")),
             "pickle": CheckpointHook(os.path.join(out_dir, "block_pickle"))}
    block = {k: [] for k in hooks}
    for hook in hooks.values():
        hook.trainer = trainer
    for _ in range(3):
        for name, hook in hooks.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hook.after_epoch()
            block[name].append(time.perf_counter() - t0)
            if name == "async":
                t1 = time.perf_counter()
                hook.wait()
                block["async write"] = block.get("async write", []) + [time.perf_counter() - t1]
    size = os.path.getsize(hooks["async"].path(trainer.progress.epoch)) / 2**20
    log(f"[yolox-m-ckpt] the loop blocked at an epoch end, YOLOX-M ({size:.1f} MiB a checkpoint: module, SGD "
        f"momentum, EMA): async hook {', '.join(f'{1000 * t:.1f}' for t in block['async'])} ms (pinned copies "
        f"queued, the write then {', '.join(f'{t:.3f}' for t in block['async write'])} s on its thread); pickle hook "
        f"(torch.save of latest.pt and epoch_<n>.pt) {', '.join(f'{1000 * t:.1f}' for t in block['pickle'])} ms; "
        f"three turns each, host clock | {card}")

    ckpt2 = torch.load(os.path.join(ckpt_dir, "2.pt"), map_location="cpu", weights_only=True)
    with open(os.path.join(ckpt_dir, "2.pt"), "rb") as f:
        head = f.read(4096)
    with open(os.path.join(ckpt_dir, "3.pt.tmp"), "wb") as f:  # a write cut short by a preemption
        f.write(head)
    restored = {}
    original = AsyncCheckpointHook.before_train

    def spy(self):
        original(self)
        t = self.trainer
        restored.update(step=t.state.step, epoch=t.progress.epoch,
                        model={k: v.detach().cpu().clone() for k, v in t.model.module.state_dict().items()},
                        ema={k: v.detach().cpu().clone() for k, v in t.state.ema_params.items()})

    path = "YOLOX-M det_train --resume, async checkpoints"
    AsyncCheckpointHook.before_train = spy
    try:
        with kernel_counts(path):
            resumed = det_train.main(_yolox_m_args(run_dir, weights, 3, flags=["--resume"]))
    finally:
        AsyncCheckpointHook.before_train = original
    check(restored["step"] == 2 * YOLOX_M_STEPS and restored["epoch"] == 3, f"the resume restored step "
          f"{restored['step']}, epoch {restored['epoch']}")
    check(all(torch.equal(restored["model"][k], v) for k, v in ckpt2["model"].items())
          and all(torch.equal(restored["ema"][k], v) for k, v in ckpt2["ema"].items()),
          "the restored parameters differ from epoch 2's checkpoint")
    check(resumed.state.step == 3 * YOLOX_M_STEPS and resumed.progress.epoch == 3, "the resumed run did not go on")
    check(sorted(os.listdir(ckpt_dir)) == ["1.pt", "2.pt", "3.pt"], f"after the resume {sorted(os.listdir(ckpt_dir))}")
    counts = check_counts(path, {"dynamic_k_matching": YOLOX_M_STEPS, "box_iou": YOLOX_M_STEPS,
                                 "nms_keep": (_evals(resumed, 3) - 2) * DATA_VAL + 1})
    log(f"[yolox-m-resume] a truncated 3.pt.tmp ({len(head)} bytes) left in the directory; --resume restored 2.pt "
        f"(step {restored['step']}, parameters and EMA equal to the file's), trained epoch {resumed.progress.epoch} to "
        f"step {resumed.state.step}, wrote 3.pt over the .tmp; kernel launches {counts} | {card}")
    return os.path.join(ckpt_dir, "3.pt")


def phase_yolox_m_amp(out_dir, weights, card):
    """The run of phase 49 under --amp TRAINER.AMP.FUSED_BN True (2 epochs): the fused kernels launched
    as often forward as backward, every step, plain versions never; the backward's calls where w
    streams (N past 640: dark5 at N = 768) counted; kernels #3 and #4 held to their plain versions
    on the first call of each distinct shape, with the step's own inputs and cotangents. Returns the
    largest |kernel - plain| per output."""
    from basedet_tpu_torch.ops.fused_bn_kernel import MAX_SMEM, backward_smem
    from basedet_tpu_torch.tools import det_train

    run_dir = os.path.join(out_dir, "yolox_m_amp")
    path = "YOLOX-M det_train --amp, fused chain"
    with kernel_counts(path), fused_backward_calls(first_per_shape=True) as backward:
        t0 = time.perf_counter()
        trainer = det_train.main(_yolox_m_args(run_dir, weights, 2, flags=["--amp"],
                                               extra=["TRAINER.AMP.FUSED_BN", "True"]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    steps = trainer.state.step
    fwd, bwd = DATA_COUNTS[path]["fused_gemm_stats"][0], DATA_COUNTS[path]["fused_gemm_stats_backward"][0]
    check(steps == 2 * YOLOX_M_STEPS and fwd == bwd > 0 and fwd % steps == 0, f"fused launches {fwd} forward, "
          f"{bwd} backward in {steps} steps")
    counts = check_counts(path, {"dynamic_k_matching": steps, "box_iou": steps, "fused_gemm_stats": fwd,
                                 "fused_gemm_stats_backward": bwd, "nms_keep": _evals(trainer, 2) * DATA_VAL + 2})
    streamed = sum(backward_smem(sig[3], sig[0], 2) > MAX_SMEM for sig, _, _ in backward)
    check(streamed > 0 and streamed % steps == 0, f"{streamed} streamed-w backward calls in {steps} steps")
    Ns = sorted({sig[3] for sig, _, _ in backward if backward_smem(sig[3], sig[0], 2) > MAX_SMEM})
    log(f"[yolox-m-amp] det_train --amp TRAINER.AMP.FUSED_BN True, YOLOX-M, {steps} steps of 8, --tb, async "
        f"checkpoints, in {seconds:.2f} s; kernel launches {counts} ({fwd // steps} fused calls a step each way); "
        f"kernel #4 streamed w on {streamed // steps} calls a step (N = {Ns}) | {card}")
    return check_fused_cases("yolox-m-fused", [(f"YOLOX-M det_train --amp {_case_name(sig)}", terms, cts)
                                               for sig, terms, cts in backward if terms is not None])


def phase_yolox_m_timing(weights, card):
    """YOLOX-M's train step at batch 8 of 640x640, f32 and bf16 with the fused chain: events ms (mean of
    YOLOX_M_REPS), peak memory above what was held before the model, the device's idle share over 3
    profiled steps."""
    out = {}
    for amp in (None, "fused"):
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        model, _, state, step, batch, _ = _train_setup(weights, "cuda", 8, amp, YOLOX_M_CONFIG,
                                                       ["DATA.NUM_CLASSES", "3"])
        batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
        step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(state, batch), reps=YOLOX_M_REPS, warmup=1)
        peak = (torch.cuda.max_memory_allocated() - before) / 2**30
        _, union, span = device_busy_span(lambda: step(state, batch), 3)
        out[AMP_LABELS[amp]] = (ms, peak, 1 - union / span)
        del model, state, step, batch
    log(f"[yolox-m-timing] YOLOX-M train step, batch 8 of 640x640 (input on the card): " + "; ".join(
        f"{name} {ms:.3f} ms ({8000 / ms:.1f} img/s), peak {peak:.2f} GiB, device idle share {idle:.3f}"
        for name, (ms, peak, idle) in out.items()) + f" (events, means of {YOLOX_M_REPS}; idle: the time no device "
        f"operation runs over the span of 3 profiled steps' device work) | {card}")


def phase_debug_nan(out_dir, card):
    """det_train --debug on the YOLOX-M config with one NaN weight must raise FloatingPointError naming the
    module whose output went non-finite first, and leave no global hook behind."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.tools import det_train, import_config

    bad = "backbone.dark4_csp.conv1.conv.weight"
    cfg = import_config(YOLOX_M_CONFIG)
    state = build_model(cfg, "cpu").module.state_dict()
    state[bad].view(-1)[0] = float("nan")
    weights = os.path.join(out_dir, "yolox_m_nan.pt")
    torch.save(state, weights)
    opts = ["DATA.TRAIN.name", "dummy", "DATA.TEST.name", "dummy", "MODEL.BATCHSIZE", "2", "SOLVER.MAX_EPOCH", "1",
            "SOLVER.NUM_IMAGE_PER_EPOCH", "2", "MODEL.WEIGHTS", weights, "GLOBAL.OUTPUT_DIR",
            os.path.join(out_dir, "debug"), "GLOBAL.CKPT_SAVE_DIR", os.path.join(out_dir, "debug", "ckpt")]
    try:
        det_train.main(["-f", YOLOX_M_CONFIG, "--device", "cuda", "--debug", *opts])
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    want = f"non-finite output of {bad.rsplit('.', 1)[0]} (Conv2d)"
    check(raised is not None and want in raised, f"det_train --debug with a NaN in {bad} raised {raised!r}")
    check(not torch.nn.modules.module._global_forward_hooks and not torch.is_anomaly_enabled(),
          "--debug left its hooks behind")
    log(f"[debug] det_train --debug, YOLOX-M with one NaN in {bad}: FloatingPointError({raised!r}) | {card}")


def phase_yolox_m(out_dir, card):
    """49. YOLOX-M (depth 0.67, width 0.75) at full width through what a long training run needs:
    make_yolox_m_weights, card against CPU (heads 1e-3), phase_yolox_m_train (TensorBoard, async
    checkpoints, resume), phase_yolox_m_eval (det_test, native matcher against Python),
    phase_yolox_m_amp (the fused kernels, streamed w), the step timed, --debug on a NaN weight.
    Returns the fused kernels' largest |kernel - plain| per output."""
    cfg, model, weights = make_yolox_m_weights(out_dir)
    phase_card_vs_cpu(cfg, model, weights, "YOLOX-M")
    del model
    ckpt = phase_yolox_m_train(out_dir, weights, card)
    phase_yolox_m_eval(out_dir, ckpt, card)
    worst = phase_yolox_m_amp(out_dir, weights, card)
    phase_yolox_m_timing(weights, card)
    phase_debug_nan(out_dir, card)
    return worst


# -- phase 50: the benchmark tool's sweep over the eleven configs, and Darknet-53 under RetinaNet's FPN ---------

BENCH_IMAGE, BENCH_B, BENCH_EVAL_B, BENCH_WARMUP, BENCH_ITERS = 640, 8, 1, 2, 6  # the JAX tool's shapes
BENCH_EVENTS_RTOL = 0.05  # the tool's host-clock step_ms against CUDA events around the same loop
# {model: {kernel: launches per train step}} on the tool's path in f32 (--amp: RoIAlign's bf16 kernels in
# place of the f32 ones) and {model: {kernel: launches per request}} in eval; TRAINER.AMP.FUSED_BN is off
BENCH_TRAIN = {
    "RetinaNet": {"box_iou": 1}, "FCOS": {}, "ATSS": {"box_iou": 1}, "FreeAnchor": {"box_iou": 2},
    "FasterRCNN": {"multilevel_roi_align": 1, "multilevel_roi_align_backward": 1, "nms_keep": 1, "box_iou": 2},
    "YOLOX-S": {"dynamic_k_matching": 1, "box_iou": 1}, "YOLOX-M": {"dynamic_k_matching": 1, "box_iou": 1},
    "YOLOv3": {"box_iou": YOLOV3_IOU_CALLS}, "CenterNet": {"scatter_rows": 3}, "OTA": {"dynamic_k_matching": 1},
    "DETR": {},
}
BENCH_EVAL = {name: {"nms_keep": 1} for name in BENCH_TRAIN}
BENCH_EVAL.update(FasterRCNN={"nms_keep": 2, "multilevel_roi_align": 1}, CenterNet={}, DETR={})
DARKNET_RETINA = ["MODEL.BACKBONE.NAME", "darknet53", "MODEL.BACKBONE.OUT_FEATURES", "('dark3','dark4','dark5')",
                  "MODEL.FPN.TOP_BLOCK_IN_FEATURE", "dark5"]


@contextlib.contextmanager
def sync_census(counts, call=1):
    """Count the synchronizing CUDA operations (``torch.cuda.set_sync_debug_mode``) of the ``call``-th
    (from 0) train step and inference call of every model built inside, into counts[the innermost
    line of the repository's code on the stack when the operation ran]."""
    import traceback
    import warnings

    from basedet_tpu_torch.engine import train_state
    from basedet_tpu_torch.utils import registry

    root = os.path.dirname(os.path.abspath(__file__)) + os.sep

    def seen_at(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack() if f.filename.startswith(root)
                and not f.filename.endswith("chip_smoke.py")]
        where = f"{ours[-1].filename[len(root):]}:{ours[-1].lineno}" if ours else \
            f"{os.path.basename(filename)}:{lineno}"
        counts[where] = counts.get(where, 0) + 1

    def census(fn):
        seen = []

        def wrapper(*args, **kwargs):
            seen.append(None)
            if len(seen) != call + 1:
                return fn(*args, **kwargs)
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = seen_at
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return fn(*args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        return wrapper

    make_step, build = train_state.make_train_step, registry.build_model

    def build_counted(*args, **kwargs):
        model = build(*args, **kwargs)
        model.inference = census(model.inference)
        return model

    train_state.make_train_step = lambda *args, **kwargs: census(make_step(*args, **kwargs))
    registry.build_model = build_counted
    try:
        yield counts
    finally:
        train_state.make_train_step, registry.build_model = make_step, build


def _check_row(row, keys):
    numbers = {k: v for k, v in row.items() if k in keys}
    check(all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0 for v in numbers.values()),
          f"benchmark row with a number not finite and positive: {row}")


def phase_benchmark(out_dir, card):
    """50. tools/benchmark.py on the card: TrainBenchmark in f32 and under --amp and EvalBenchmark at
    batch 1, called directly (any failure fails the run), for the eleven names at 640x640 and batch 8,
    BENCH_WARMUP + BENCH_ITERS steps or calls; each row's kernel launches counted (BENCH_TRAIN,
    BENCH_EVAL; plain 0), its numbers finite and positive, its peak printed; the synchronizing CUDA
    operations of one f32 step and one request named by source line; YOLOX-S's f32 step_ms against
    CUDA events around the same loop. Then Darknet-53 under RetinaNet's FPN: det_train 2 steps of 2
    at 800x1333 (#10 once a step), det_test over its 8 requests (#1 once a request)."""
    from basedet_tpu_torch.tools import benchmark

    class EventFenced(benchmark.TrainBenchmark):
        """The tool's TrainBenchmark with a CUDA event recorded at each of its fences."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.events = []

        def sync(self):
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.events.append(event)
            super().sync()

    t0 = time.perf_counter()
    syncs = {}
    for name in benchmark.MODELS:
        for mode, amp in (("train", False), ("train", True), ("eval", False)):
            path = f"{name} benchmark {mode}{' --amp' if amp else ''}"
            census = {}
            with kernel_counts(path), sync_census(census):
                if mode == "eval":
                    bench = benchmark.EvalBenchmark(name, BENCH_IMAGE, BENCH_EVAL_B, BENCH_WARMUP, BENCH_ITERS)
                else:
                    cls = EventFenced if (name, amp) == ("YOLOX-S", False) else benchmark.TrainBenchmark
                    bench = cls(name, BENCH_IMAGE, BENCH_B, BENCH_WARMUP, BENCH_ITERS, amp=amp)
                row = bench.run()
            calls = BENCH_WARMUP + BENCH_ITERS
            per = BENCH_EVAL[name] if mode == "eval" else BENCH_TRAIN[name]
            if amp and name == "FasterRCNN":
                per = {("multilevel_roi_align_bf16" if k == "multilevel_roi_align" else
                        "multilevel_roi_align_backward_bf16" if k == "multilevel_roi_align_backward" else k): v
                       for k, v in per.items()}
            counts = _new_counts(path, {k: v * calls for k, v in per.items()})
            _check_row(row, ("images_per_sec", "step_ms", "warmup_s", "latency_ms"))
            check(bench.peak_gib is not None and bench.peak_gib > 0, f"{path}: peak {bench.peak_gib}")
            if mode == "train":
                check(bench.steps == calls and math.isfinite(bench.loss), f"{path}: {bench.steps} steps, loss "
                      f"{bench.loss}")
            else:
                check(all(torch.isfinite(v.float()).all() for v in bench.dets.values()), f"{path}: detections")
            if census:
                syncs[path] = census
            log(f"[bench] {json.dumps(row)}")
            log(f"[bench] {path}: peak {bench.peak_gib:.3f} GiB above what was held; launches {counts}; host syncs "
                f"in one {'request' if mode == 'eval' else 'step'}: {census or 'none'}"
                f"{'; warmup_s includes the nvcc build of ' + ', '.join(bench.built) if bench.built else ''} | {card}")
            if isinstance(bench, EventFenced):
                check(len(bench.events) == 3, f"the tool fenced {len(bench.events)} times, not 3")
                events_ms = bench.events[1].elapsed_time(bench.events[2]) / BENCH_ITERS
                check(abs(row["step_ms"] - events_ms) <= BENCH_EVENTS_RTOL * events_ms,
                      f"YOLOX-S step_ms {row['step_ms']} against {events_ms:.3f} by CUDA events")
                log(f"[bench] YOLOX-S f32: the tool's step_ms {row['step_ms']} against {events_ms:.3f} ms by CUDA "
                    f"events around the same {BENCH_ITERS} steps (within {BENCH_EVENTS_RTOL:.0%})")
            del bench
    log(f"[bench] {len(benchmark.MODELS) * 3} rows in {time.perf_counter() - t0:.1f} s; the steps and requests "
        f"that synchronize with the host: " + ("; ".join(f"{p}: {c}" for p, c in syncs.items()) or "none")
        + f" | {card}")
    phase_darknet_retina(out_dir, card)


def phase_darknet_retina(out_dir, card):
    """Darknet-53 (train-mode BN, dark3-dark5, p6p7 on dark5) under full-width RetinaNet's FPN and head:
    det_train 2 steps of 2 images of 800x1333 (#10 once a step), det_test on its dump over 8 requests
    (#1 once a request), plain 0, finite losses and detections."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.tools import det_test, det_train, import_config

    run_dir = os.path.join(out_dir, "darknet_retina")
    cfg = import_config(RETINA_CONFIG)
    cfg.merge([*DARKNET_RETINA, *_retina_opts(run_dir)])
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    model = build_model(cfg, "cuda", generator)
    randomise_retina(model.module, generator)
    weights = os.path.join(out_dir, "retinanet_darknet53_seed0.pt")
    torch.save(model.module.state_dict(), weights)
    n_params = sum(p.numel() for p in model.module.parameters())
    del model
    opts = [*DARKNET_RETINA, *_retina_train_opts(run_dir, weights)]
    opts[opts.index("SOLVER.NUM_IMAGE_PER_EPOCH") + 1] = str(2 * RETINA_B)
    keep_losses = lambda args, out: {k: float(v.detach()) for k, v in out[1].items()}
    from basedet_tpu_torch.models.det.retinanet import RetinaNet

    t0 = time.perf_counter()
    with kernel_counts("RetinaNet Darknet-53 det_train"), recording(RetinaNet, "get_losses", keep_losses) as losses:
        trainer = det_train.main(["-f", RETINA_CONFIG, "--device", "cuda", *opts])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(trainer.state.step == 2 and len(losses) == 2, f"Darknet-53 RetinaNet took {trainer.state.step} steps")
    check(all(math.isfinite(v) and v >= 0 for step in losses for v in step.values()), f"losses {losses}")
    train_counts = _new_counts("RetinaNet Darknet-53 det_train", {"box_iou": 2})
    dumped = os.path.join(run_dir, "retina_ckpt", "dumped_model.pt")
    t1 = time.perf_counter()
    with kernel_counts("RetinaNet Darknet-53 det_test"):
        results = det_test.main(["-f", RETINA_CONFIG, "-w", dumped, "--device", "cuda", *DARKNET_RETINA,
                                 *_retina_opts(run_dir)])
    torch.cuda.synchronize()
    test_seconds = time.perf_counter() - t1
    test_counts = _new_counts("RetinaNet Darknet-53 det_test", {"nms_keep": 8})
    with open(os.path.join(run_dir, "predict_coco.json")) as f:
        records = json.load(f)
    check(np.isfinite([r["bbox"] + [r["score"]] for r in records]).all(), "non-finite detections")
    log(f"[darknet-retina] RetinaNet on darknet53 ({n_params} parameters, train-mode BN, p6p7 on dark5): det_train "
        f"2 steps of {RETINA_B} of {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} in {seconds:.2f} s, losses "
        f"{[{k: round(v, 4) for k, v in s.items()} for s in losses]}, launches {train_counts}; det_test over 8 "
        f"requests in {test_seconds:.2f} s: {results}, {len(records)} finite detections, launches {test_counts} "
        f"| {card}")



# -- the HF backbone zoo under the detectors (phase 51) ----------------------------------------------

HF_DETECTORS = {  # model: (config, HF preset, extra options, {kernel: det_train launches a step},
    #                      {kernel: det_test launches a request}, randomise)
    "RetinaNet": (RETINA_CONFIG, "resnet50", None, {"box_iou": 1}, {"nms_keep": 1}, "retina"),
    "Faster R-CNN": (FRCNN_CONFIG, "regnety_040", ["MODEL.BACKBONE.OUT_FEATURES", "('res2','res3','res4','res5')"],
                     {"multilevel_roi_align": 1, "multilevel_roi_align_backward": 1, "nms_keep": 1, "box_iou": 2},
                     {"multilevel_roi_align": 1, "nms_keep": 2}, "frcnn"),
}
HF_STEPS, HF_REQUESTS = 4, 8


def _hf_opts(name):
    """The options that put ``name`` on its HF preset: RetinaNet's are those ``auto_convert_cfg_to_hf``
    writes (res3-res5, p6p7 on res5), checked against the function; Faster R-CNN keeps res2-res5."""
    from basedet_tpu_torch.layers.backbone.hf_adaptor import auto_convert_cfg_to_hf
    from basedet_tpu_torch.tools import import_config

    config, preset, extra, *_ = HF_DETECTORS[name]
    if extra is not None:
        return ["MODEL.BACKBONE.NAME", f"hf_{preset}", *extra]
    cfg = auto_convert_cfg_to_hf(import_config(config), preset)
    opts = ["MODEL.BACKBONE.NAME", cfg.MODEL.BACKBONE.NAME, "MODEL.BACKBONE.OUT_FEATURES",
            str(tuple(cfg.MODEL.BACKBONE.OUT_FEATURES)).replace(" ", ""), "MODEL.FPN.TOP_BLOCK_IN_FEATURE",
            cfg.MODEL.FPN.TOP_BLOCK_IN_FEATURE]
    merged = import_config(config)
    merged.merge(opts)
    check(tuple(merged.MODEL.BACKBONE.OUT_FEATURES) == tuple(cfg.MODEL.BACKBONE.OUT_FEATURES)
          and merged.MODEL.FPN.TOP_BLOCK_IN_FEATURE == cfg.MODEL.FPN.TOP_BLOCK_IN_FEATURE,
          f"{name}: the options are not auto_convert_cfg_to_hf's rewrite")
    return opts


def _hf_card_vs_cpu(name, cfg, model, weights):
    """One eval request (800x1333) on the card and on the CPU from the dumped weights, f32 with TF32
    off: the HF backbone's res2-res5 (as requested), the FPN levels and the head outputs (RetinaNet)
    or the proposals (Faster R-CNN), each to HEAD_ATOL of its largest entry; detections matched as
    phases 12 and 22 match them (FRCNN_AGREE)."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.data import build_test_dataloader
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.utils.compare import match_detections

    cpu = build_model(cfg, "cpu")
    cpu.load_weights(weights)
    request = next(iter(build_test_dataloader(cfg)))
    request = {k: request[k] for k in ("data", "im_info")}

    def stages(m):
        m.eval()
        with torch.inference_mode(), full_f32():
            x = m.pre_process(request)
            bottom_up = m.module.bottom_up(x["image"])
            feats = m.module.fpn(bottom_up)
            out = {**bottom_up, **feats}
            proposals = None
            if name == "RetinaNet":
                logits, offsets = m.module.head([out[n] for n in m.module.level_names])
                out.update({f"logits {n}": v for n, v in zip(m.module.level_names, logits)})
                out.update({f"offsets {n}": v for n, v in zip(m.module.level_names, offsets)})
            else:
                proposals = [t.cpu() for t in m.module.proposals(feats, x["img_info"])]
        return ({k: v.float().cpu() for k, v in out.items()}, proposals,
                {k: v.cpu().numpy() for k, v in m.inference(request).items()})

    t0 = time.perf_counter()
    c_stages, c_prop, c_dets = stages(cpu)
    cpu_s = time.perf_counter() - t0
    g_stages, g_prop, g_dets = stages(model)
    err = {k: float((g_stages[k] - v).abs().max() / v.abs().max().clamp_min(1e-30)) for k, v in c_stages.items()}
    frac = match_detections(c_dets, g_dets)
    check(max(err.values()) <= HEAD_ATOL, f"{name} on its HF backbone: card and CPU stages differ: {err}")
    check(np.isfinite(g_dets["boxes"]).all() and g_dets["valid"].any(), f"{name}: card detections empty or non-finite")
    check(frac >= FRCNN_AGREE, f"{name}: only {frac:.3f} of the CPU's detections matched on the card")
    text = ""
    if c_prop is not None:  # proposal slots as phase 12 matches them (two near-tied scores may swap)
        prop_frac, prop_err = _slot_agreement(c_prop[0], c_prop[1], g_prop[0], g_prop[1])
        check(prop_frac >= FRCNN_AGREE, f"{name}: only {prop_frac:.3f} of the CPU's proposals matched on the card")
        text = f"; proposals {prop_frac:.4f} of slots matched, max |dbox| {prop_err:.3e} on them"
    return (f"card vs CPU on one {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} request (CPU {cpu_s:.1f} s), max |diff| over max "
            f"|value|: {', '.join(f'{k} {v:.2e}' for k, v in err.items())} (tol {HEAD_ATOL}){text}; "
            f"{int(c_dets['valid'].sum())} CPU / {int(g_dets['valid'].sum())} card detections, {frac:.4f} matched "
            f"(min {FRCNN_AGREE})")


def phase_hf_detectors(out_dir, card):
    """51. The HF backbone zoo (``layers/backbone/hf_adaptor.py``) under full-width detectors: RetinaNet
    on hf_resnet50 (``auto_convert_cfg_to_hf``) and Faster R-CNN on hf_regnety_040 (res2-res5 under
    P2-P6), random weights from SEED with the biases spread as phases 11 and 19 spread them, every HF
    BN in train mode. Each: det_train HF_STEPS steps of 2 images of 800x1333 in f32 (launches of #10,
    and of #1, #5 and #6 for Faster R-CNN, as HF_DETECTORS says, plain 0), each step's wall time and
    the run's peak memory; det_test on its dump over HF_REQUESTS requests (#1, and #5 for Faster
    R-CNN, plain 0), finite detections; the dump on the card against the CPU (``_hf_card_vs_cpu``)."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.tools import det_test, import_config

    for name, (config, preset, _, train_launches, test_launches, spread) in HF_DETECTORS.items():
        run_dir = os.path.join(out_dir, f"hf_{preset}")
        hf = _hf_opts(name)
        test_opts = [*hf, *(_retina_opts(run_dir) if spread == "retina" else _frcnn_opts(run_dir))]
        cfg = import_config(config)
        cfg.merge(test_opts)
        generator = torch.Generator(device="cuda").manual_seed(SEED)
        model = build_model(cfg, "cuda", generator)
        (randomise_retina if spread == "retina" else randomise_frcnn)(model.module, generator)
        weights = os.path.join(out_dir, f"{spread}_hf_{preset}_seed0.pt")
        torch.save(model.module.state_dict(), weights)
        n_params = sum(p.numel() for p in model.module.parameters())
        n_backbone = sum(p.numel() for p in model.module.bottom_up.parameters())
        del model
        train_opts = _retina_train_opts(run_dir, weights) if spread == "retina" else _frcnn_train_opts(run_dir, weights)
        args = ["-f", config, "--device", "cuda", *hf, *train_opts]
        path = f"{name} hf_{preset} det_train"
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        steps, _ = _dp_plain(args, path)
        peak = torch.cuda.max_memory_allocated() - before
        check(len(steps) == HF_STEPS, f"{path} took {len(steps)} steps")
        check(all(math.isfinite(v) and v >= 0 for s in steps for v in s["losses"].values()),
              f"{path}: losses {[s['losses'] for s in steps]}")
        train_counts = _new_counts(path, {k: v * HF_STEPS for k, v in train_launches.items()})
        ckpt = "retina_ckpt" if spread == "retina" else "frcnn_ckpt"
        dumped = os.path.join(run_dir, ckpt, "dumped_model.pt")
        test_path = f"{name} hf_{preset} det_test"
        t0 = time.perf_counter()
        with kernel_counts(test_path):
            results = det_test.main(["-f", config, "-w", dumped, "--device", "cuda", *test_opts])
        torch.cuda.synchronize()
        test_seconds = time.perf_counter() - t0
        test_counts = _new_counts(test_path, {k: v * HF_REQUESTS for k, v in test_launches.items()})
        with open(os.path.join(run_dir, "predict_coco.json")) as f:
            records = json.load(f)
        check(records and np.isfinite([r["bbox"] + [r["score"]] for r in records]).all(),
              f"{test_path}: no or non-finite detections")
        model = build_model(cfg, "cuda")
        model.load_weights(dumped)
        parity = _hf_card_vs_cpu(name, cfg, model, dumped)
        del model
        step_ms, step_text = _median_ms(steps)
        log(f"[hf] {name} on hf_{preset} ({n_params} parameters, {n_backbone} in the HF backbone, train-mode BN): "
            f"det_train {HF_STEPS} steps of 2 of {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} in f32, step wall time without the "
            f"loader's batch {step_text}, peak {peak / 2**30:.2f} GiB above what was held "
            f"(torch.cuda.max_memory_allocated over the det_train run), losses "
            f"{[{k: round(v, 4) for k, v in s['losses'].items()} for s in steps]}, launches {train_counts}; det_test "
            f"over {HF_REQUESTS} requests in {test_seconds:.2f} s: {results}, {len(records)} finite detections, "
            f"launches {test_counts}; {parity} | {card}")


# -- the fused CSP chain under data-parallel training (phase 52) --------------------------------------

# YOLOX-S dark3's CSPLayer (128 -> 128, n = 3) at 832x832 (104x104 maps), a global batch of 8 whose
# second half (rank 1's rows) is scaled by 3 and shifted by 1, so that statistics taken over one rank's
# rows would be far from the global batch's
FUSED_DP_C, FUSED_DP_N, FUSED_DP_HW, FUSED_DP_B = 128, 3, 104, 8
FUSED_DP_STEPS = 3
# Two ranks against one process on that CSPLayer: each rank's output and input gradient against its
# rows of the one process's, the parameter gradients (the ranks' mean times 2) and the running
# statistics against its. The ranks change only the order of the BN sums (each rank's kernel column
# sums, then the all-reduce in float64), as the plain versions change it against the kernels (within
# FUSED_SUM_RTOL a sum); scale and shift then move by f32 ulps and a few bf16 roundings flip, and the
# BN backward amplifies those flips in its weights' gradients. So each quantity's largest difference
# (over the largest magnitude) is held to FUSED_DP_FLOOR times the one process's kernels-against-plain-
# versions difference on the same inputs, measured in the same run, and never less than one bf16 ulp
# (y, dx, the conv kernels' gradients, rounded to bf16) or 1e-5 (the f32 BN gradients and statistics)
FUSED_DP_FLOOR = 2.0
# det_train --amp with the fused chain over two ranks against one process, the first step's losses:
# bf16 train-mode YOLOX-S with random weights turns any change in the order of sums into changes of
# its predictions at bf16's size (phase 9c: the kernels' step 0.685 of the gradient's norm from its
# plain-version step), and SimOTA then re-assigns near-tied anchors; the first step of the first run
# measured 4.8% (cls_loss; NVIDIA H100 80GB HBM3, 700.00 W). Later steps start from parameters that
# this has moved apart (the BN buffers 0.162 of max(|value|, 1) apart after 3 steps in the second
# run), so they and the state are printed beside the same comparison without the fused chain, not
# held. The CSPLayer check above holds the reduction itself
FUSED_DP_LOSS_RTOL = 0.1


def _csp_fused_case(device):
    """YOLOX-S dark3's CSPLayer (fused-eligible: dense, SiLU) with weights, BN affine and running
    statistics from SEED, a bf16 input of FUSED_DP_B images at FUSED_DP_HW² and an f32 output
    cotangent, on ``device``."""
    from basedet_tpu_torch.layers.blocks.yolo_block import CSPLayer
    from basedet_tpu_torch.layers.common.blocks import FlaxBatchNorm2d

    g = torch.Generator().manual_seed(SEED + 52)
    layer = CSPLayer(FUSED_DP_C, FUSED_DP_C, n=FUSED_DP_N)
    with torch.no_grad():
        for m in layer.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) / m.weight[0].numel() ** 0.5)
            elif isinstance(m, FlaxBatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g), m.bias.normal_(0.0, 0.3, generator=g)
                m.running_mean.normal_(0.0, 0.2, generator=g), m.running_var.uniform_(0.5, 2.0, generator=g)
    shape = (FUSED_DP_B, FUSED_DP_C, FUSED_DP_HW, FUSED_DP_HW)
    x = torch.randn(shape, generator=g) * 2
    x[FUSED_DP_B // 2:] = x[FUSED_DP_B // 2:] * 3 + 1
    return layer.to(device), x.to(torch.bfloat16).to(device), torch.randn(shape, generator=g).to(device)


def _csp_fused_pass(layer, x, dy):
    """The layer in train mode under the bf16 policy with the fused chain, on ``x``; backward of
    Σ y·dy; the parameter gradients averaged over the data group (the identity without one). →
    output, input gradient, parameter gradients and running statistics, on the CPU."""
    from basedet_tpu_torch import parallel
    from basedet_tpu_torch.layers.precision import precision_policy

    layer.train()
    x = x.clone().requires_grad_(True)
    with precision_policy(torch.bfloat16, True):
        y = layer(x)
    (y.float() * dy).sum().backward()
    parallel.all_reduce_grads(list(layer.parameters()))
    torch.cuda.synchronize()
    return {"y": y.detach().cpu(), "dx": x.grad.cpu(),
            "grads": {n: p.grad.cpu() for n, p in layer.named_parameters()},
            "stats": {k: v.cpu() for k, v in layer.state_dict().items() if "running" in k}}


def dp_csp_layer(path):
    """One rank's share of phase 52's CSPLayer check: its rows of the global batch, under a process
    group over gloo; the kernel counts zeroed just before, read just after."""
    from basedet_tpu_torch import parallel

    parallel.init_from_env(torch.device("cuda"), "gloo")
    try:
        layer, x, dy = _csp_fused_case(torch.device("cuda"))
        with kernel_counts(path):
            res = _csp_fused_pass(layer, parallel.shard_rows(x), parallel.shard_rows(dy))
    finally:
        parallel.shutdown()
    return {**res, "counts": DATA_COUNTS[path]}


def _fused_dp_args(out_dir, weights, multi_host, per_rank, backend=None, fused=True):
    args = _yolox_dp_args(out_dir, weights, multi_host, per_rank, FUSED_DP_B * FUSED_DP_STEPS, backend)
    return [*args[:4], "--amp", *args[4:], *(["TRAINER.AMP.FUSED_BN", "True"] if fused else [])]


def phase_fused_dp(out_dir, weights, card, gloo, nccl):
    """52. The fused CSP chain (TRAINER.AMP.FUSED_BN) under data-parallel training, its BN sums
    all-reduced over the data group (``parallel.group_stats``). Two ranks sharing the card over gloo
    (``torchrun --nproc-per-node 2``): YOLOX-S dark3's CSPLayer at 832x832 on 4 images a rank against
    one process on the 8 (FUSED_DP_*); full-width YOLOX-S ``det_train --amp TRAINER.AMP.FUSED_BN True
    --multi-host`` FUSED_DP_STEPS steps of 4 a rank against the plain det_train at 8 (the first
    step's losses to FUSED_DP_LOSS_RTOL; the later ones, the BN buffers and the parameters' update
    printed beside the same comparison without the fused chain), both ranks bit-equal, #3 and #4 36
    times a step per rank, #2 and #10 once, plain 0; the run without the fused chain also for its
    step time. Then world size 1 over NCCL against the plain det_train (the first step's losses to
    FUSED_DP_LOSS_RTOL). Returns {kernel: {path: launches}}."""
    dp_dir = os.path.join(out_dir, "fused_dp")
    os.makedirs(dp_dir, exist_ok=True)
    from unittest import mock

    from basedet_tpu_torch.ops import fused_bn_kernel
    from basedet_tpu_torch.ops.fused_bn import fused_gemm_stats_backward_plain, fused_gemm_stats_plain, unflatten_terms

    want = _csp_fused_pass(*_csp_fused_case(torch.device("cuda")))
    with mock.patch.object(fused_bn_kernel, "_launch_forward",
                           lambda call: fused_gemm_stats_plain(unflatten_terms(call.spec, call.flat))), \
            mock.patch.object(fused_bn_kernel, "_launch_backward",
                              lambda terms, M, N, device, *cts: fused_gemm_stats_backward_plain(terms, *cts)):
        plain_pass = _csp_fused_pass(*_csp_fused_case(torch.device("cuda")))
    plain_path = "YOLOX-S det_train --amp FUSED_BN, plain beside the DP runs"
    plain, plain_state = _dp_plain(_fused_dp_args(os.path.join(dp_dir, "plain"), weights, False, FUSED_DP_B),
                                   plain_path)
    plain_unfused, unfused_state = _dp_plain(_fused_dp_args(os.path.join(dp_dir, "plain_unfused"), weights, False,
                                                            FUSED_DP_B, fused=False),
                                             "YOLOX-S det_train --amp, plain beside the DP runs")
    runs, _ = gloo
    eps = float(torch.finfo(torch.bfloat16).eps)
    rows = FUSED_DP_B // 2

    def differences(parts):
        """{quantity: largest |difference| over the largest |value|} of ``parts`` ([(rank rows or None,
        result)]) against the one process's kernel pass."""
        out = {}
        for sl, got in parts:
            pairs = [(k, got[k], want[k] if sl is None else want[k][sl]) for k in ("y", "dx")]
            pairs += [("conv kernels" if n.endswith("conv.weight") else "BN weights and biases",
                       got["grads"][n] * (2 if sl is not None else 1), w) for n, w in want["grads"].items()]
            pairs += [("running stats", got["stats"][n], w) for n, w in want["stats"].items()]
            for k, g, w in pairs:
                rel = float((g.float() - w.float()).abs().max()) / max(float(w.float().abs().max()), 1e-30)
                out[k] = max(out.get(k, 0.0), rel)
        return out

    floor = differences([(None, plain_pass)])
    worst = differences([(slice(r * rows, (r + 1) * rows), got) for r, got in enumerate(runs["csp"])])
    least = {"y": eps, "dx": eps, "conv kernels": eps, "BN weights and biases": 1e-5, "running stats": 1e-5}
    for r, got in enumerate(runs["csp"]):
        fwd, bwd = got["counts"]["fused_gemm_stats"], got["counts"]["fused_gemm_stats_backward"]
        check(fwd == (FUSED_DP_N + 3, 0) and bwd == (FUSED_DP_N + 3, 0),
              f"CSPLayer rank {r}: fused launches {fwd}, backward {bwd} (launches, plain calls)")
    for k, v in worst.items():
        check(v <= max(FUSED_DP_FLOOR * floor[k], least[k]),
              f"the two ranks' fused CSPLayer against one process's: {k} {v:.3g}, the plain versions' {floor[k]:.3g}")
    log(f"[fused-dp] dark3's CSPLayer (128 -> 128, n = 3) under the fused chain, two ranks sharing the card over gloo "
        f"(4 of 8 images a rank at {FUSED_DP_HW}x{FUSED_DP_HW}, rank 1's scaled by 3 and shifted by 1) against one "
        f"process, largest |difference| over largest |value|: "
        f"{', '.join(f'{k} {v:.3g} (plain versions {floor[k]:.3g})' for k, v in worst.items())} (tol "
        f"{FUSED_DP_FLOOR}x the plain versions', at least one bf16 ulp or 1e-5); {FUSED_DP_N + 3} + "
        f"{FUSED_DP_N + 3} fused launches a rank | {card}")
    launches = {}
    label = "YOLOX-S det_train --amp FUSED_BN --multi-host, 2 ranks over gloo"
    ranks = runs["fused"]
    check(all(r["world"] == 2 and len(r["steps"]) == FUSED_DP_STEPS for r in ranks), "fused: not 2 ranks' steps")
    for k, v in ranks[0]["state"].items():
        check(torch.equal(v, ranks[1]["state"][k]), f"{label}: the ranks' {k} differ")
    per_step = {"fused_gemm_stats": 36, "fused_gemm_stats_backward": 36, "dynamic_k_matching": 1, "box_iou": 1}
    for r, res in enumerate(ranks):
        for kernel, (n, plain_calls) in res["counts"].items():
            expect = per_step.get(kernel, 0) * FUSED_DP_STEPS
            check(n == expect and plain_calls == 0, f"{label} rank {r}: {kernel} launched {n} times, not {expect}; "
                                                    f"plain {plain_calls}")
            if n:
                launches.setdefault(kernel, {})[f"{label} (rank {r})"] = n
    check_counts(plain_path, {k: v * FUSED_DP_STEPS for k, v in per_step.items()})
    loss_err = _fused_dp_losses(label, ranks[0]["steps"], plain)
    init = torch.load(weights, map_location="cpu")

    def apart(state, want):
        """(BN buffers' largest |difference| over max(|value|, 1), the parameters' update's deviation)."""
        buffers = max(float(((state[k] - w).abs() / w.abs().clamp_min(1.0)).max())
                      for k, w in want.items() if k.endswith(("running_mean", "running_var")))
        return buffers, _update_deviation(state, want, init)

    buffers, update = apart(ranks[0]["state"], plain_state)
    unfused_loss_err = _losses_apart(runs["unfused"][0]["steps"], plain_unfused)
    unfused_buffers, unfused_update = apart(runs["unfused"][0]["state"], unfused_state)
    fused_ms, fused_text = _median_ms(ranks[0]["steps"])
    unfused_ms, unfused_text = _median_ms(runs["unfused"][0]["steps"])
    nccl, _ = nccl
    res = nccl["fused"][0]
    nccl_label = "YOLOX-S det_train --amp FUSED_BN --multi-host (NCCL, world size 1)"
    for kernel, (n, plain_calls) in res["counts"].items():
        expect = per_step.get(kernel, 0) * FUSED_DP_STEPS
        check(n == expect and plain_calls == 0, f"{nccl_label}: {kernel} launched {n} times, not {expect}")
        if n:
            launches.setdefault(kernel, {})[nccl_label] = n
    nccl_err = _fused_dp_losses(nccl_label, res["steps"], plain)
    # per fused call and step: one all-reduce of [Σx, Σx², n] forward (float64, 2N + 1) and one of the
    # sums' cotangents backward (f32, 2N) for each BN of the chain; the grads' buckets apart
    from basedet_tpu_torch.layers.blocks.yolo_block import CSPLayer
    from basedet_tpu_torch.tools import import_config
    from basedet_tpu_torch import build_model

    model = build_model(import_config(CONFIG), "cpu")
    widths = [b.bn.weight.numel() for m in model.module.modules() if isinstance(m, CSPLayer) for _, b in m._blocks()]
    del model
    log(f"[fused-dp] the fused CSP chain under data-parallel training (in phase 44's and phase 43's torchrun launches, two "
        f"ranks sharing the card over gloo): {label}: "
        f"{FUSED_DP_STEPS} steps of 4 a rank, losses {loss_err} off one process's at 8 by step (the first held to "
        f"{FUSED_DP_LOSS_RTOL}), BN buffers {buffers:.3g} of max(|value|, 1) and the parameters' update {update:.4g} "
        f"of its norm off one process's (not held); without the fused chain, the same comparison: losses "
        f"{unfused_loss_err}, BN buffers {unfused_buffers:.3g}, update {unfused_update:.4g}; the ranks bit-equal; per "
        f"rank launches {', '.join(f'{k} {v[0]}' for k, v in ranks[0]['counts'].items() if v[0])}, plain 0; step "
        f"wall time without the loader's batch, rank 0: fused {fused_text}, unfused --amp {unfused_text} "
        f"({fused_ms / unfused_ms:.3f}x), one process at 8 with the fused chain {_median_ms(plain)[1]}; "
        f"collectives a step for the chain: {2 * len(widths)} all-reduces ({len(widths)} BNs, one forward and one "
        f"backward each) of {sum(8 * (2 * c + 1) + 4 * 2 * c for c in widths)} bytes; {nccl_label}: losses "
        f"{nccl_err} off the plain run's by step (the first held to {FUSED_DP_LOSS_RTOL}) | {card}")
    return launches


def _losses_apart(got, want):
    """The largest relative difference of each step's losses from ``want``'s, as "a/b/c"."""
    return "/".join(f"{max(abs(g['losses'][k] - v) / max(abs(v), 1e-12) for k, v in w['losses'].items() if v):.2e}"
                    for g, w in zip(got, want))


def _fused_dp_losses(name, got, want):
    """Every step's losses finite and with ``want``'s keys, the first step's within FUSED_DP_LOSS_RTOL of
    ``want``'s (FUSED_DP_LOSS_RTOL says why the later ones are not held); ``_losses_apart``."""
    for i, (g, w) in enumerate(zip(got, want)):
        check(g["losses"].keys() == w["losses"].keys() and all(math.isfinite(v) for v in g["losses"].values()),
              f"{name} step {i + 1}: losses {g['losses']}")
    text = _losses_apart(got, want)
    check(float(text.split("/")[0]) <= FUSED_DP_LOSS_RTOL,
          f"{name} step 1: losses {got[0]['losses']} against {want[0]['losses']} (rtol {FUSED_DP_LOSS_RTOL})")
    return text


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR", help="also profile inference and the train steps, tables into DIR")
    parser.add_argument("--parent-iou", metavar="IOU_CU", help="also build another tree's csrc/iou.cu and time it "
                        "beside this one's, in turns")
    parser.add_argument("--dp-worker", metavar="DIR", help=argparse.SUPPRESS)  # one rank of phases 43-44
    parser.add_argument("--dp-tag", help=argparse.SUPPRESS)
    parser.add_argument("--dp-runs", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.dp_worker:
        dp_worker(args.dp_worker, args.dp_tag, json.loads(args.dp_runs))
        return
    card = phase_device()
    phase_build()
    kernel = phase_kernel(card)
    matching = phase_matching(card)
    roi = phase_roi_align(card)
    roi_bwd = phase_roi_align_bwd(card)
    roi_bf16, roi_bwd_bf16 = phase_roi_align_bf16(card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        cfg, model, weights = make_weights(out_dir)
        match_launches, dumped, yolox_iou = phase_train(out_dir, weights)
        launches = phase_slice(out_dir, cfg, dumped)
        phase_card_vs_cpu(cfg, model, weights)
        phase_train_vs_cpu(weights)
        steps = {None: phase_train_timing(weights, card)}
        fused_fwd, fused_bwd, fused_step = phase_fused_kernels(weights, card)
        (amp_fused, amp_fused_bwd, amp_match), amp_err, amp_dumped = phase_train_amp(out_dir, weights)
        amp_nms = phase_slice(out_dir, cfg, amp_dumped, "YOLOX-S det_test of the --amp run")
        for errs in (amp_err, phase_amp_train_vs_cpu(weights)):
            for report, err in zip((fused_fwd, fused_bwd), _fused_errs(errs)):
                report["max_abs_err"] = max(report["max_abs_err"], err)
        steps["bf16"] = phase_train_timing(weights, card, "bf16")
        steps["fused"] = phase_train_timing(weights, card, "fused", fused_step)
        frcnn_cfg, frcnn, frcnn_weights = make_frcnn_weights(out_dir)
        (train_roi, train_roi_bwd, train_nms), frcnn_dumped, frcnn_iou = phase_frcnn_train(out_dir, frcnn_weights)
        roi_launches, frcnn_nms_launches = phase_frcnn_slice(out_dir, frcnn_dumped)
        phase_frcnn_card_vs_cpu(frcnn_cfg, frcnn, frcnn_weights)
        phase_frcnn_train_vs_cpu(frcnn_weights)
        phase_frcnn_train_timing(frcnn_weights, card)
        cnet_weights = make_cnet_weights(out_dir)
        cnet_launches, scatter_stages, cnet_dumped = phase_cnet_train(out_dir, cnet_weights)
        scatter = phase_scatter_kernel(card, scatter_stages)
        del scatter_stages
        phase_cnet_slice(out_dir, cnet_dumped)
        phase_cnet_card_vs_cpu(cnet_weights)
        cnet_step = phase_cnet_train_timing(cnet_weights, card, scatter["ms"])
        retina_cfg, retina, retina_weights = make_retina_weights(out_dir)
        retina_iou, retina_dumped = phase_retina_train(out_dir, retina_weights)
        iou = phase_iou_kernel(card, {
            "RetinaNet det_train (gts, anchors)": retina_iou,
            "Faster R-CNN det_train RPN targets (gts, anchors)": frcnn_iou["rpn"],
            "Faster R-CNN det_train R-CNN sampling (candidates, gts)": frcnn_iou["rcnn"],
            "YOLOX-S det_train SimOTA (gts, predicted boxes)": yolox_iou}, args.parent_iou)
        del retina_iou, frcnn_iou, yolox_iou
        retina_nms = phase_retina_slice(out_dir, retina_dumped)
        phase_retina_card_vs_cpu(retina_cfg, retina, retina_weights)
        retina_step = phase_retina_train_timing(retina_weights, card)
        phase_data_set(out_dir)
        phase_data_train(out_dir, card)
        phase_data_resume(out_dir, card)
        phase_data_other_models(out_dir, frcnn_weights, cnet_weights, card)
        phase_data_bench(out_dir, card)
        phase_new_models(out_dir, card)
        phase_last_families(out_dir, card)
        for report, err in zip((roi_bf16, roi_bwd_bf16), phase_amp_families(out_dir, card)):
            report["max_abs_err"] = max(report["max_abs_err"], err)
        nccl, gloo = dp_launches(out_dir, weights, frcnn_weights)
        dp_match, dp_iou = phase_dp_nccl(out_dir, weights, card, nccl)
        dp_counts = phase_dp_gloo(out_dir, weights, frcnn_weights, card, gloo)
        for name, paths in (("dynamic_k_matching", dp_match), ("box_iou", dp_iou)):
            dp_counts.setdefault(name, {}).update(paths)
        phase_tp(out_dir, card, gloo)
        phase_trace(out_dir, weights, frcnn_weights, card)
        phase_profile_tool(out_dir, card)
        phase_analyze(card)
        for report, err in zip((fused_fwd, fused_bwd), _fused_errs(phase_yolox_m(out_dir, card))):
            report["max_abs_err"] = max(report["max_abs_err"], err)
        phase_benchmark(out_dir, card)
        phase_hf_detectors(out_dir, card)
        for name, paths in phase_fused_dp(out_dir, weights, card, gloo, nccl).items():
            dp_counts.setdefault(name, {}).update(paths)
    totals = phase_timing(model, card)
    if args.profile:
        batches = {bs: _timing_batch(bs) for bs in (1, 32)}
        phase_profile(card, args.profile, [
            *((f"b{bs}", f"YOLOX-S f32 640x640 batch {bs}", functools.partial(model.inference, batches[bs]), iters,
               totals[bs]) for bs, iters in ((1, 5), (32, 3))),
            *((f"step_{amp or 'f32'}", f"YOLOX-S {AMP_LABELS[amp]} train step, batch 8 of 640x640", run, 3, ms)
              for amp, (ms, run) in steps.items())])
    phase_frcnn_timing(frcnn, card)
    phase_retina_timing(retina, card)
    if args.profile:
        phase_profile(card, args.profile, [
            ("step_centernet", f"CenterNet R50-DCNv2 f32 train step, batch {CNET_B} of {CNET_IMAGE[0]}x"
             f"{CNET_IMAGE[1]}", cnet_step[1], 3, cnet_step[0]),
            ("step_retinanet", f"RetinaNet R50-FPN f32 train step, batch {RETINA_B} of {FRCNN_IMAGE[0]}x"
             f"{FRCNN_IMAGE[1]}", retina_step[1], 3, retina_step[0])])

    def by_path(kernel, named):
        """{main path: launches} of one kernel: the paths counted by name here, then those that
        ``kernel_counts`` counted, then the data-parallel ranks' (phases 43-44)."""
        return {**named, **{path: counts[kernel][0] for path, counts in DATA_COUNTS.items() if counts[kernel][0]},
                **dp_counts.get(kernel, {})}

    iou_by_path = {**{path: launches for path, (launches, _) in IOU_COUNTS.items()}, **dp_counts["box_iou"]}
    nms_by_path = by_path("nms_keep", {
        "YOLOX-S det_test": launches, "YOLOX-S det_test of the --amp run": amp_nms,
        "Faster R-CNN det_train": train_nms, "Faster R-CNN det_test": frcnn_nms_launches,
        "RetinaNet det_test": retina_nms})
    match_by_path = by_path("dynamic_k_matching", {"YOLOX-S det_train": match_launches,
                                                   "YOLOX-S det_train --amp": amp_match})
    roi_by_path = by_path("multilevel_roi_align", {"Faster R-CNN det_train": train_roi,
                                                   "Faster R-CNN det_test": roi_launches})
    roi_bwd_by_path = by_path("multilevel_roi_align_backward", {"Faster R-CNN det_train": train_roi_bwd})
    roi_bf16_by_path = by_path("multilevel_roi_align_bf16", {})
    roi_bwd_bf16_by_path = by_path("multilevel_roi_align_backward_bf16", {})
    fused_by_path = by_path("fused_gemm_stats", {"YOLOX-S det_train --amp": amp_fused})
    fused_bwd_by_path = by_path("fused_gemm_stats_backward", {"YOLOX-S det_train --amp": amp_fused_bwd})
    scatter_by_path = by_path("scatter_rows", {"CenterNet det_train": cnet_launches})
    log(f"[report] launches on the paths kernel_counts counted: " + "; ".join(
        f"{path}: " + (", ".join(f"{k} {v[0]}" for k, v in counts.items() if v[0]) or "none")
        for path, counts in DATA_COUNTS.items()))
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    entry = lambda paths, numbers: {"launches": sum(paths.values()), "launches_by_path": paths,
                                    **{k: numbers[k] for k in keys}}
    report = {"kernels": [{
        "name": "nms_keep", "route": "cuda", "source": "basedet_tpu_torch/csrc/nms.cu",
        "replaces": "basedet_tpu/ops/nms_pallas.py:26", **entry(nms_by_path, kernel),
    }, {
        "name": "dynamic_k_matching", "route": "cuda", "source": "basedet_tpu_torch/csrc/matching.cu",
        "replaces": "basedet_tpu/ops/matching_pallas.py:31", **entry(match_by_path, matching),
    }, {
        "name": "multilevel_roi_align", "route": "cuda", "source": "basedet_tpu_torch/csrc/roi_align.cu",
        "replaces": "basedet_tpu/ops/roi_align_window.py:257 and basedet_tpu/ops/roi_align_pallas.py:54",
        **entry(roi_by_path, roi),
    }, {
        "name": "multilevel_roi_align_backward", "route": "cuda",
        "source": "basedet_tpu_torch/csrc/roi_align.cu",
        "replaces": "basedet_tpu/ops/roi_align_window.py:355 and basedet_tpu/ops/roi_align_pallas.py:94",
        **entry(roi_bwd_by_path, roi_bwd),
    }, {
        "name": "multilevel_roi_align_bf16", "route": "cuda", "source": "basedet_tpu_torch/csrc/roi_align.cu",
        "replaces": "basedet_tpu/ops/roi_align_window.py:257 and basedet_tpu/ops/roi_align_pallas.py:54 (bf16)",
        **entry(roi_bf16_by_path, roi_bf16),
    }, {
        "name": "multilevel_roi_align_backward_bf16", "route": "cuda",
        "source": "basedet_tpu_torch/csrc/roi_align.cu",
        "replaces": "basedet_tpu/ops/roi_align_window.py:355 and basedet_tpu/ops/roi_align_pallas.py:94 (bf16)",
        **entry(roi_bwd_bf16_by_path, roi_bwd_bf16),
    }, {
        "name": "fused_gemm_stats", "route": "cuda", "source": "basedet_tpu_torch/csrc/fused_bn.cu",
        "replaces": "basedet_tpu/ops/fused_bn.py:152", **entry(fused_by_path, fused_fwd),
    }, {
        "name": "fused_gemm_stats_backward", "route": "cuda", "source": "basedet_tpu_torch/csrc/fused_bn.cu",
        "replaces": "basedet_tpu/ops/fused_bn.py:257", **entry(fused_bwd_by_path, fused_bwd),
    }, {
        "name": "scatter_rows", "route": "cuda", "source": "basedet_tpu_torch/csrc/scatter_rows.cu",
        "replaces": "basedet_tpu/ops/scatter_onehot.py:117", **entry(scatter_by_path, scatter),
        "bf16": scatter["bf16"],
    }, {
        "name": "box_iou", "route": "cuda", "source": "basedet_tpu_torch/csrc/iou.cu",
        "replaces": "basedet_tpu/ops/iou_pallas.py:37", **entry(iou_by_path, iou),
    }]}
    log(json.dumps(report))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
