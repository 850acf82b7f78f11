"""Smoke run of the PyTorch port on one CUDA GPU: build, check, serve, train.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is nonzero:

1. report the card (nvidia-smi name and power limit) and versions;
2. build the kernels from their eleven sources with nvcc, one build per
   source, all side by side (a fresh checkout always builds; a second run
   loads the builds), and report the builds of tspn_tpu_torch/csrc/
   q8s_sm90.cu (K1 and K6, wgmma) and q8s.cu (K4, dp4a);
3. hold K1 (q8s) and K6 (q8t) against their plain PyTorch versions at six
   geometries: the serve path's three (tracklet, rel, expanded), the pair-
   kernel bench's 95,232 x 11,264 rows, a ragged 95,155 and a VidOR
   segment's 333 pairs, with ragged row counts and zero rows: K1 and K6
   equal to plain and K6 to K1 transposed, bit for bit (torch.equal);
   time each with CUDA events (``runtime.timing.cuda_median_ms``: 3
   warm-ups, then the median of 5 runs of 20 queued calls) beside its
   plain version, the dp4a template they left (K4 on the same rows) and
   torch._int_mm on the same rows (a yardstick the port never calls),
   with its plan (split or not, pieces, staging) and % of the bound;
4. report the q8f_fused build (csrc/q8f_fused.cu) and hold it against its
   plain version bit for bit at four geometries: the serve geometry (16 x
   992 rows, N 32), a ragged row count, the PPN-pruned geometry (16 x 256
   rows with non-canonical pairs) and pairs with out-of-range indices;
   time both;
5. serve q8f: 96 synthetic full-width VidVRD segments (C 35, R 132),
   buckets [8, 16, 24, 32], batch 16, top-k 20/200, weights from a seeded
   normal(0.01) init carried across with state_dict_from_jax; run
   predict_segments on the GPU with the kernels and with the plain
   versions, the kernels at pipeline_depth 2 and 0, in turns (plain,
   kernel, kernel at depth 0 twice, kernel, plain; SERVE_TURNS) after one
   untimed run of each; each batch must launch q8s once (tracklet pass)
   and q8f_fused once (rel pass), and the top-k selections must be equal,
   at either depth; one more kernel run at each depth in a traced run
   (see phase 15) gives the device's busy share;
6. serve q8: the same over expanded int8 rows, one q8s launch per batch;
7. report the build of the fused_classify kernel
   (tspn_tpu_torch/csrc/fused_classify.cu, three-pass TF32 wgmma);
8. hold the fused_classify kernel against its plain version (TF32 off)
   at the training geometry (P 7936, D 11264, R 132), at a ragged P
   (7923) and at the fused serve geometry (16 x 992 rows), each with zero
   padding rows and a zero BoW block, within
   |kernel - plain| <= 1e-5 * (|N(x)| @ |W| + |b|) + 1e-6 per element
   (the worst err/bound printed), two runs equal bit for bit; time the
   kernel, its plain version, the weights' TF32 prep and cuBLAS SGEMM of
   rows normalized beforehand (a yardstick the port never calls), and
   print the plan (tiles, pieces of D) with the bound of three TF32
   passes and the f32 CUDA-core bound beside it;
9. serve fused f32: 48 synthetic segments (half at 32 tracklets) RAW in
   the device layout through predict_segments with the fused model in
   inference mode, kernel and plain in turns as in phase 5; the kernel
   must launch once per batch, and the top-k selections must be equal
   apart from entries whose score lies within 1e-6 of another's;
10. train fused: 24 steps over the same 48 labeled segments (batch 8,
    buckets [8, 16, 24, 32], Adam with warm-up and both milestones inside
    the 24 steps), plain and with the kernel in turns (plain, kernel,
    kernel, plain) from the same carried-across init; each kernel run's
    step 1 losses must agree with plain's to rtol 1e-4, every step to
    rtol 1e-3, the last loss must be below the first, and the kernel
    must launch once per step; a shorter kernel run in a traced run
    gives the device's busy share;
11. serve PPN-pruned (configs/tspn_config.yaml with PRUNE_AT_INFERENCE):
    the segments of phases 5 and 6 through a model with the PPN head
    (35 -> 64 -> 35, seeded init carried across), NUM_PAIR_PROPOSALS 256,
    kernel and plain in turns; the same launches per batch as unpruned,
    equal selections, one traced run;
12. train PPN: phase 10 with the PPN head and its loss; loss_rel and
    loss_pair at step 1 agree to rtol 1e-4 and every step to 1e-3, and
    the last total loss is below the first;
13. report the build of the RoIAlign kernel K7
    (tspn_tpu_torch/csrc/roi_align.cu);
14. hold K7 against roi_align_plain (run in chunks of 256 RoIs) bit for
    bit: at the detect geometry (8 images of 40 x 40 x 1024, 2048 RoIs,
    some off the map, out 14, s 2), at a ragged RoI count, at the
    detector-training geometry (4 images, 512 RoIs as in phase 27), and
    at the boundary boxes of tests/test_roi_align.py at (7, 2) and (4, 1);
    time both, with the channels a thread;
15. detect at full width: Faster R-CNN R101-C4 at DetectionConfig's
    defaults (35 classes, RPN 1000/256, RoIAlign 14 x 14), seeded init
    with the cls_score bias of classes 0-2 raised to 3 so that the 0.05
    score threshold keeps detections; 20 seeded 640 x 640 frames through
    detect_video_frames in batches of 8 (the last padded), with K7 and
    with the plain RoIAlign in turns as in phase 5; frames/s the median of
    two timed runs, one K7 launch per batch, every frame keeping
    detections; K7 and the plain RoIAlign on the same backbone features
    give the same detections apart from near-ties; one detect_tta batch
    and one roi_classeme call (one launch each); one traced run
    (benchmark.trace's Tracer and DeviceTrace) for the busy share, K7's
    share of the device time and the summary of the port's spans (each
    tspn.* span's count, host seconds, self seconds and the device's idle
    seconds inside it);
16. report the builds of csrc/q8s_sm90.cu (K6), csrc/q8s.cu (K4),
    csrc/q8_bf16.cu (K5) and csrc/pair_probe.cu (the probe, wgmma);
17. hold K4 (q8i8), K5 (q8bf), K6 (q8t) and the probe against their plain
    versions (run in chunks of 8192 rows) at the geometry of
    tools/bench_pair_kernels.py (96 x 992 = 95,232 rows, D 11,264), at a
    ragged 95,155 rows and at the VidOR layout (C 80, D 11,392, 333 rows),
    each with zero rows and empty BoW blocks: K4, K6 and the probe (all
    three modes) equal bit for bit, K4 equal to K1 and K6 to K1
    transposed on the same rows, K5 within |K5 - plain| <= 1e-5 *
    (|q_h| @ |w_h| s + sum_k |q_k| @ |w_k| / L1_k + |b|) + 1e-6; then the
    probe alone, all three modes bit for bit, at 1 and 4,096 pairs of D
    11,264 and at 4,096 and 333 pairs of D 64; time kernel and plain, and
    torch._int_mm beside the probe where it takes the shapes (its time is
    a yardstick; the port never calls it); each probe line prints its %
    of the bound and its plan (how x was staged, the split of D);
18. run the ported tool, python -m tspn_tpu_torch.tools.bench_pair_kernels,
    at its default 96 segments: K1, the probe in its three modes, K6, one
    launch per timed call of each leg;
19. report the build of csrc/rel.cu (Kr, Kn and Ks4, the kernels of the
    rel-pass probe tools);
20. hold Kr, Kn and Ks4 against their plain versions (run in chunks of
    8192 rows) at the tools' geometry (95,232 rows of 3,072 int8 columns,
    R 132), at a ragged 95,155 rows and at 333 rows (a VidOR segment's
    pairs), each with zero rows: Kr int32, Kn and Ks4 equal to the int64
    products (Ks4's of the wrapped weights), Kr f32 equal to its plain
    version, Kr side equal to K1's plain version at rel_geom in every
    schedule (row grid with 2, 3 and 4 stages, persistent with 2 and 4,
    split-K by 2 and 4, the 128-wide sidecar), so split-K equals no
    split; at the tools' geometry Kr side equal to K1's kernel output,
    and each kernel, its plain version, K1 and torch._int_mm (a
    yardstick the port never calls) timed, with the bound beside each;
21. run the four ported rel tools, python -m
    tspn_tpu_torch.tools.bench_rel_{steps,pipeline,probe,int4}, at their
    defaults as one main-path group: every leg is checked against its
    plain version once and timed, so each kernel leg launches once for its
    check and once per timed call, and Kr, Kn and Ks4 each launch;
22. report the build of K3's bf16 half (csrc/fused_classify_bf16.cu) and
    hold it against its plain version at phase 8's three geometries, the
    rows rounded to bf16: |kernel - plain| <= 1e-5 * T + 2**-8 * M per
    element (T the summed |terms| plus |b|, M the largest |term|), with
    at most 0.1% of the outputs needing the second term (the count is
    printed); time both;
23. the bf16 relation model (MODEL.DTYPE bfloat16) as one main-path group:
    fused serve of phase 9's 48 segments (bf16 rows from the loader, one
    fused_classify_bf16 launch per batch, top-k equal to plain apart from
    near-ties of 1e-5), unfused serve of the same 48 segments in the
    storage layout (bf16 Linear, no kernel of the port), and 24 fused
    bf16 training steps kernel against plain in turns (step 1 within
    rtol 1e-3, every step 1e-2, the loss falls), each with rates, a
    traced pass and its host-to-device copy time;
24. report the build of csrc/roi_probes.cu (T-roi 1-3) and hold
    roi_sep_fused, roi_selector and roi_constg against their plain
    versions at the RoIAlign tools' defaults (4 x 256 RoIs, 40 x 40 x
    1024) in f32 and bf16 within 1e-5 * T + 1e-6 (plus one bf16 ulp for a
    bf16 output); time kernel, plain and, for selector and constg,
    torch.matmul with G materialized (a yardstick the port never calls),
    each line with its % of the bound; then hold selector and constg (in
    bf16 the wgmma + TMA kernel, in f32 the SIMT one) to plain within the
    same bounds at the edges of their stacked-row tiling: one RoI, three,
    a 29 x 33 map, C = 384 and a 128 x 128 map, and roi_sep_fused at the
    same edges where it takes them (it refuses the 128 x 128 map: W >
    112), at C = 96 and at W = 112;
25. run the two ported RoIAlign tools, python -m
    tspn_tpu_torch.tools.bench_roialign_{fused,variants}, at their
    defaults in f32 and bf16 as one main-path group: each holds its
    kernel legs to their plain versions and every leg to roi_align_plain,
    then times it (K7 runs the variants tool's grid leg, in bf16 on its
    bf16 half);
26. report the build of csrc/roi_align.cu's bf16 and backward entry
    points, and hold K7's bf16 half against roi_align_plain on the same
    bf16 maps (widened, pooled in f32, rounded once) bit for bit at phase
    14's five geometries (8 channels a thread: 16-byte accesses); time
    both;
27. hold K7's backward against the plain backward (autograd of
    roi_align_plain in chunks of 256 RoIs, summed in f32, rounded once
    for a bf16 map) in f32 and bf16 at the training geometry (4 images of
    40 x 40 x 1024, 512 RoIs: GT-like boxes inside the map and proposals,
    some partly off it), a ragged 475 RoIs and the border boxes at (7, 2)
    and (4, 1), within |kernel - plain| <= 1e-5 * T + 1e-6 per element (T
    the plain backward of |dOut|; plus one bf16 ulp of the plain value in
    bf16); time both at the training geometry;
28. train the detector at full width through detection.train.train_detector:
    R101-C4, 35 classes, DetectorTrainConfig's defaults (4 images a batch,
    640 letterbox, RPN 256, RoI 128, NMS 2000/512), 16 seeded in-memory
    480 x 640 records with 1-8 flat boxes of random classes on noise,
    5 steps a run (DET_TRAIN_STEPS) from the seeded init, with K7 (forward and
    backward) and with the plain RoIAlign in turns (plain, kernel,
    kernel, plain), in f32 and then in bf16 (--bf16): step-1 losses
    kernel against plain within rtol 1e-4 (bf16: 1e-2), every loss
    finite; steps/s the median of each side's runs (a run's rate over its
    steps after the first); one traced step for the busy share, K7's
    forward and backward shares and the summary of the port's spans;
    peak memory; a traced f32 run of train_detector's own loop
    (DET_TRAIN_TRACED_STEPS steps) whose summary holds one tspn.input_wait
    span a step; the checkpoint of the first kernel run reloads into a
    detector that detects;
29. serve the bf16 detector: phase 15 with the model in bf16 (K7's bf16
    half against the plain bf16 RoIAlign in turns, frames/s, the same
    detections apart from near-ties, TTA, classeme, a traced pass);
30. report the build of csrc/nms.cu and hold the NMS kernel against the
    blocked loop it replaced, both on the card, bit for bit at the three
    calls of the detector's cells (tspn_tpu_torch/tools/nms_cases.py: the
    RPN at 4 x 12,000 -> 2,000 and 8 x 6,000 -> 1,000, the class-aware
    field at 8 x 35,000 -> 100); time the whole call (sort and kernel),
    the sort alone and the blocked loop with CUDA events. Its launches
    are counted in the main-path groups of phases 15, 28-29 and 32: two a
    detect batch (RPN, class-aware), one a training step, one more a TTA
    call;
31. bind csrc/roi_align.cu's levels entry points (K7's levels form, the
    FPN's multi-level RoIAlign) and hold them against
    roi_align_levels_plain (per-level roi_align_plain, in chunks of 512
    RoIs) at the X101-FPN cells' geometries: the forward bit for bit at
    8 images' P2-P5 of 768 x 1344 (256 channels) with 8,000 RoIs of every
    level (and a ragged 7,993) and at 4 of 800 x 1344 with 512, one launch
    a call; the backward within 1e-5 * T + 1e-6 (T the plain backward of
    |dOut|) at 512 and a ragged 475 RoIs; time kernel and plain at 8,000
    and 512 RoIs beside the bound (the output written once, the
    backward's dOut read once; the maps are not counted, as a RoI reads
    only what lies under it);
32. X101-32x8d-FPN at FPNConfig's defaults on the main path: 16 seeded
    768 x 1344 frames through detect_video_frames in batches of 8 with
    K7's levels form (a warm-up run, a run) and with the plain per-level
    RoIAlign, the same detections apart from near-ties and every frame
    keeping some; then train_detector (shortest-edge inputs, 3 steps a
    run) with K7 and with the plain form, step-1 losses within rtol 1e-4:
    one levels forward a detect batch and a training step, one levels
    backward a training step.

Convolutions and matrix products run in full f32 (TF32 off throughout).
The kernel launches of the main path are counted from zero before each
main-path phase group and read right after it: phases 5-6, 9-10, 11-12,
15, 18, 21, 23, 25, 28-29 and 32. K4 and K5 run on no main path (the JAX
package has no caller for them either); their check launches stand in
their entries. It prints the kernels' JSON line, then as its last line
{"ok": true, "device": {...}}. Without a CUDA device it exits nonzero
before printing any result.
"""

from __future__ import annotations

import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace as NS

import torch

from tspn_tpu_torch.ops.pairwise import BlockGeom, rel_geom, tracklet_geom
from tspn_tpu_torch.runtime.timing import ITERS, REPS, WARMUP, bound, cuda_median_ms
from tspn_tpu_torch.tools.bench_pair_kernels import PROBE_ROWS

SEED = 0
NUM_SEGMENTS = 96
SERVE = dict(buckets=(8, 16, 24, 32), batch_size=16, topk_per_pair=20,
             topk_per_seg=200, num_objects=35)
NUM_PREDICATES = 132
FEATURE_DIM = 11070
FUSED_SEGMENTS = 48
TRAIN_STEPS = 24
PROFILED_STEPS = 8
TRAIN = dict(buckets=(8, 16, 24, 32), batch_size=8, seed=SEED)
# configs/baseline.yaml's solver with the schedule cut to the 24 steps
SOLVER = NS(
    BASE_LR=1e-2, BIAS_LR_FACTOR=2, WEIGHT_DECAY=5e-4, WEIGHT_DECAY_BIAS=0.0,
    OPTIMIZER=NS(TYPE="adam", MOMENTUM=0.9),
    SCHEDULER=NS(TYPE="warmup_multi", MILESTONES=[12, 18], GAMMA=0.1,
                 WARMUP_FACTOR=1.0 / 3, WARMUP_ITERS=4, WARMUP_METHOD="linear"),
)
TIE_TOL = 1e-6
# a serve phase's timed runs: (variant, pipeline_depth), the kernels at
# depth 2 and 0 and the plain versions in turns; with the warm-up and the
# two profiled passes a serve phase makes KERNEL_SERVE_RUNS kernel runs
SERVE_TURNS = (("plain", 2), ("kernel", 2), ("kernel", 0), ("kernel", 0), ("kernel", 2),
               ("plain", 2))
KERNEL_SERVE_RUNS = 1 + sum(v == "kernel" for v, _d in SERVE_TURNS) + 2
# bf16 fused serve: kernel and plain round a normalized value near a bf16
# midpoint one ulp apart now and then (2**-8 of one term of a logit)
TIE_TOL_BF16 = 1e-5
COPY = "Memcpy HtoD"  # the profiler's name for host-to-device copies
# fused_classify checks: (name, rows, zero padding rows); the training
# geometry is 8 segments x 992 pairs, the serve geometry 16 x 992
FUSED_CASES = (("train", 7936, 0), ("train_ragged", 7936 - 13, 40),
               ("serve", 16 * 992, 400))
# the PPN of configs/tspn_config.yaml: 35 -> 64 -> 35 per role, K = 256
PPN_HIDDEN, PPN_OUT, NUM_PAIR_PROPOSALS = 64, 35, 256
# q8f_fused checks: (name, segments, rows per segment, tracklets N, pairs)
K2_CASES = (("serve", 16, 992, 32, "canonical"), ("ragged", 7, 333, 19, "random"),
            ("pruned", 16, 256, 32, "random"), ("out_of_range", 16, 256, 32, "outside"))
# RoIAlign (K7) checks: (name, images, H, W, C, RoIs, out, s, boxes)
K7_CASES = (("detect", 8, 40, 40, 1024, 2048, 14, 2, "random"),
            ("ragged", 8, 40, 40, 1024, 2048 - 77, 14, 2, "random"),
            ("train", 4, 40, 40, 1024, 512, 14, 2, "train"),
            ("border_7x2", 1, 20, 24, 1024, 8, 7, 2, "border"),
            ("border_4x1", 1, 20, 24, 1024, 8, 4, 1, "border"))
# the boundary boxes of tests/test_roi_align.py, in feature coordinates
BORDER_BOXES = ((2.0, 3.0, 10.0, 12.0), (-3.0, -2.0, 5.0, 6.0), (18.0, 14.0, 30.0, 26.0),
                (0.0, 0.0, 24.0, 20.0), (5.0, 5.0, 5.0, 5.0), (-4.0, -3.0, 5.0, 6.0),
                (18.0, 14.0, 28.0, 24.0), (-1.5, -1.0, 0.5, 21.0))
# NMS checks: the detector cells' three calls (tools/nms_cases.py)
NMS_CASES = ("rpn_train", "rpn_detect", "class_aware")
PLAIN_CHUNK = 256  # RoIs per roi_align_plain call: its (R, 28, W, C) gather
# K7 backward checks: the training geometry (4 images, 128 RoIs each), a
# ragged count and the borders; "train" boxes are half GT-like, half
# proposals drawn over the map (some hanging off it)
K7_BACKWARD_CASES = (("train", 4, 40, 40, 1024, 512, 14, 2, "train"),
                     ("ragged", 4, 40, 40, 1024, 512 - 37, 14, 2, "train"),
                     ("border_7x2", 1, 20, 24, 1024, 8, 7, 2, "border"),
                     ("border_4x1", 1, 20, 24, 1024, 8, 4, 1, "border"))
# detector training: seeded 480 x 640 records, the steps of each run
DET_TRAIN_RECORDS, DET_TRAIN_STEPS, DET_TRAIN_HW = 16, 5, (480, 640)
DET_TRAIN_TRACED_STEPS = 2  # the traced run of train_detector's loop
# the detector: 640 x 640 letterboxed frames in batches of 8
# (tools/run_pipeline.py and detect_video_frames defaults)
DET_FRAMES, DET_BATCH, DET_SIZE = 20, 8, 640
DET_RAISED_CLASSES, DET_RAISED_BIAS = 3, 3.0
DET_TIE = 1e-5
# X101-32x8d-FPN (phases 31-32): K7's levels form at the benchmark cells'
# geometries, (name, images, canvas (H, W), RoIs, timed): P2-P5 of 256
# channels at strides 4-32, RoIs of every level; the detector on the main
# path, FPN_FRAMES frames of FPN_FRAME_HW in batches of DET_BATCH and
# FPN_TRAIN_STEPS training steps a run
K7_LEVELS_CASES = (("detect", 8, (768, 1344), 8000, True),
                   ("detect_ragged", 8, (768, 1344), 7993, False),
                   ("train", 4, (800, 1344), 512, True))
K7_LEVELS_BACKWARD_CASES = (("train", 4, (800, 1344), 512, True),
                            ("ragged", 4, (800, 1344), 475, False))
FPN_SCALES = (1 / 4, 1 / 8, 1 / 16, 1 / 32)
LEVELS_CHUNK = 512  # RoIs per plain call: its P2 gather is (R, 14, 336, 256)
FPN_FRAMES, FPN_FRAME_HW, FPN_TRAIN_STEPS = 16, (768, 1344), 3
# K4, K5, K6 and probe checks: (name, objects C of the layout, rows); the
# tool geometry is NUM_SEGMENTS x 992 pairs of tools/bench_pair_kernels.py
VARIANT_CASES = (("tool", 35, NUM_SEGMENTS * 992), ("ragged", 35, NUM_SEGMENTS * 992 - 77),
                 ("vidor", 80, 333))
VARIANT_CHUNK = 8192  # rows per plain call: a float64 copy of 95k x 11264 is 8.6 GB
# K1 and K6 checks: (name, geometry (None: the VidOR layout), rows, outputs);
# the serve path's three with ragged row counts (the tracklet pass, the
# rel rows of the rel-pass tools, the expanded q8 rows), the geometry of
# tools/bench_pair_kernels.py, its ragged count, and a VidOR segment's pairs
K1_CASES = (("tracklet", tracklet_geom(), 3072 - 7, 2 * NUM_PREDICATES),
            ("rel", rel_geom(), NUM_SEGMENTS * 992 - 29, NUM_PREDICATES),
            ("expanded", BlockGeom(3072, 8, 1024), 4096 - 13, NUM_PREDICATES),
            ("tool", BlockGeom(3072, 8, 1024), NUM_SEGMENTS * 992, NUM_PREDICATES),
            ("ragged", BlockGeom(3072, 8, 1024), NUM_SEGMENTS * 992 - 77, NUM_PREDICATES),
            ("vidor", None, 333, NUM_PREDICATES))
# the probe alone: (name, pairs P, width D): one pair and 4,096 (D split
# across blocks, x by TMA), and D 64 (one zero-padded chunk)
PROBE_CASES = (("p1", 1, 11264), ("p4096", 4096, 11264), ("d64", 4096, 64),
               ("vidor_d64", 333, 64))
# Kr, Kn and Ks4 checks: (name, rows); the tool geometry is that of the
# tools/bench_rel_*.py probes, D 3072 (rel_geom) and R 132
REL_CASES = (("tool", NUM_SEGMENTS * 992), ("ragged", NUM_SEGMENTS * 992 - 77), ("vidor", 333))
# Kr side schedules: (name, stages, schedule, ks, sidecar width)
# the RoIAlign probe tools' default geometry: 4 images of 40 x 40 x 1024, 256 RoIs each
ROI_TOOL = NS(batch=4, rois=256, hw=40, channels=1024)
# the GEMM's tiling edges (T-roi 2, 3): (name, images, RoIs, H, W, C): one
# RoI (a single partial 128-row tile), three (tiles straddling RoIs), a
# non-square map whose 8 x 8 blocks overhang, C = 384 (an odd count of
# 128-channel tiles) and the largest map taken
ROI_EDGE_CASES = (("r1", 1, 1, 40, 40, 1024), ("r3", 2, 3, 16, 16, 256),
                  ("29x33", 2, 5, 29, 33, 256), ("c384", 2, 4, 16, 16, 384),
                  ("128x128", 1, 4, 128, 128, 256))
# roi_sep_fused only: C = 96 (32 x odd) with 13 RoIs (a part-empty 8-RoI
# block), and W = 112, the widest it takes
ROI_SEP_EDGE_CASES = (("c96", 2, 13, 24, 24, 96), ("w112", 1, 5, 40, 112, 256))
REL_SCHEDULES = (("grid2", 2, "grid", 1, 16), ("grid3", 3, "grid", 1, 16),
                 ("grid4", 4, "grid", 1, 16), ("persistent2", 2, "persistent", 1, 16),
                 ("persistent4", 4, "persistent", 1, 16), ("ksplit2", 2, "grid", 2, 16),
                 ("ksplit4", 2, "grid", 4, 16), ("persistent2_side128", 2, "persistent", 1, 128))


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_kernel_check(dev) -> dict:
    """K1 and K6 (csrc/q8s_sm90.cu) against their plain versions at the six
    geometries of K1_CASES, ragged P, zero rows: K1 and K6 equal to plain
    and K6 to K1 transposed, bit for bit; each timed beside its plain
    version, the dp4a template they left (K4, which still runs on it) and
    torch._int_mm on the same rows, with its plan and % of the bound."""
    from tspn_tpu_torch.data.layout import FeatureLayout
    from tspn_tpu_torch.ops import pairwise as pw

    gen = torch.Generator(device=dev).manual_seed(SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    report = {"q8s": {}, "q8t": {}}
    for name, geom, p, r in K1_CASES:
        geom = geom or FeatureLayout.for_objects(80)
        d, nseg = geom.device_dim, geom.num_bow_blocks + 1
        q = torch.randint(-127, 128, (p, d), generator=gen, device=dev, dtype=torch.int8)
        q[-50:] = 0  # padded batch rows are all-zero
        scales = torch.rand((p, 16), generator=gen, device=dev) / 64
        qw_t = torch.randint(-127, 128, (r, d), generator=gen, device=dev, dtype=torch.int8)
        sw = torch.rand((r,), generator=gen, device=dev) / 127
        b = torch.randn((r,), generator=gen, device=dev)
        xt, scales_t = q.T.contiguous(), scales.T.contiguous()
        k1 = lambda: pw.normalize_classify_q8s(q, scales, qw_t, sw, b, geom)
        k6 = lambda: pw.normalize_classify_q8t(xt, scales_t, qw_t, sw, b, geom)
        plain1 = lambda: in_chunks(p, 0, lambda s: pw.normalize_classify_q8s_plain(
            q[s], scales[s], qw_t, sw, b, geom))
        plain6 = lambda: in_chunks(p, 1, lambda s: pw.normalize_classify_q8t_plain(
            xt[:, s], scales_t[:, s], qw_t, sw, b, geom))
        out1, out6, ref = k1(), k6(), plain1()
        torch.cuda.synchronize()
        if out1.shape != (p, r) or not torch.isfinite(out1).all():
            raise AssertionError(f"q8s {name}: bad output {tuple(out1.shape)}")
        err = {"q8s": float((out1 - ref).abs().max()), "q8t": float((out6 - ref.T).abs().max())}
        if not torch.equal(out1, ref):
            raise AssertionError(f"q8s {name}: kernel != plain, max |err| {err['q8s']}")
        if not torch.equal(out6, ref.T) or not torch.equal(out6, plain6()):
            raise AssertionError(f"q8t {name}: kernel != plain or K1 transposed, "
                                 f"max |err| {err['q8t']}")
        del ref
        # the dp4a template (csrc/q8s.cu): K4 on the same rows, its block
        # scales computed in the kernel
        dp4a_ms = cuda_median_ms(lambda: pw.normalize_classify_q8i8(
            q, scales[:, 0].contiguous(), qw_t, sw, b, geom))
        # torch._int_mm, never called by the port: q @ qw_t.T padded to 8 columns
        w_pad = torch.zeros((d, -(-r // 8) * 8), dtype=torch.int8, device=dev)
        w_pad[:, :r] = qw_t.T
        lib_ms = {"q8s": cuda_median_ms(lambda: torch._int_mm(q, w_pad))}
        # K6's own form, w (R, D) @ xt, takes P % 8 == 0 only
        lib_ms["q8t"] = (cuda_median_ms(lambda: torch._int_mm(qw_t, xt)) if p % 8 == 0
                         else lib_ms["q8s"])
        del w_pad
        operands = {"q8s": (q, scales[:, :nseg], qw_t, sw, b),
                    "q8t": (xt, scales_t[:nseg], qw_t, sw, b)}
        for key, kern, plain, out, transposed in (("q8s", k1, plain1, out1, False),
                                                  ("q8t", k6, plain6, out6, True)):
            plan = pw.q8s_plan(p, r, d, geom, sms, transposed)
            c = report[key][name] = {
                "rows": p, "width": d, "cols": r, "max_abs_err": err[key],
                "ms": cuda_median_ms(kern), "plain_ms": cuda_median_ms(plain, iters=3),
                "dp4a_ms": dp4a_ms, "library_ms": lib_ms[key],
                "plan": {"split": plan.split, "pieces": len(plan.pieces), "items": plan.items,
                         "staging": plan.staging, "grid": plan.grid},
                **bound(operands[key], out, 2.0 * p * d * r, "int8")}
            log(f"{key} {name}: P={p} D={d} R={r} equal=True kernel {c['ms']:.4f} ms "
                f"({100 * c['bound_ms'] / c['ms']:.1f}% of the {c['bound_ms']:.4f} ms bound, "
                f"{c['bound_by']}) plain {c['plain_ms']:.4f} ms dp4a (K4) {dp4a_ms:.4f} ms "
                f"torch._int_mm {lib_ms[key]:.4f} ms; plan {c['plan']}")
        del q, xt, out1, out6
        torch.cuda.empty_cache()
    return report


def k2_inputs(gen, bsz: int, p: int, n: int, pairs_kind: str, dev):
    """q8f_fused operands at the rel geometry (D 3072, R 132): int8 rows
    (zero padding rows at the end of each segment), the rows' scales,
    pairs canonical (subject-major over N tracklets, then (0, 0)
    padding), random, or random with a share outside [0, N), and an A
    table of tracklet-pass magnitude."""
    from tspn_tpu_torch.ops import pairwise as pw

    d, r = pw.rel_geom().device_dim, NUM_PREDICATES
    x = torch.randint(-127, 128, (bsz, p, d), generator=gen, dtype=torch.int8)
    x[:, -5:] = 0
    s = torch.rand((bsz, p), generator=gen) / 64
    if pairs_kind == "canonical":
        sub, obj = torch.nonzero(~torch.eye(n, dtype=torch.bool), as_tuple=True)
        pairs = torch.zeros((bsz, p, 2), dtype=torch.int32)
        pairs[:, : sub.numel()] = torch.stack([sub, obj], -1).to(torch.int32)
    else:
        pairs = torch.randint(0, n, (bsz, p, 2), generator=gen, dtype=torch.int32)
        if pairs_kind == "outside":
            pairs[:, ::7, 0] = n + 3
            pairs[:, 1::5, 1] = -1
            pairs[:, ::11, 1] = n
    qw_t = torch.randint(-127, 128, (r, d), generator=gen, dtype=torch.int8)
    sw = torch.rand((r,), generator=gen) / 127
    b = torch.randn((r,), generator=gen)
    a = torch.randn((bsz, n, 2 * r), generator=gen) * 4
    return [t.to(dev) for t in (x, s, pairs, qw_t, sw, b, a)]


def phase_k2_check(dev) -> dict:
    """q8f_fused vs its plain version, bit for bit, at four geometries."""
    from tspn_tpu_torch.ops import pairwise as pw

    gen = torch.Generator().manual_seed(SEED + 2)
    report = {}
    for name, bsz, p, n, kind in K2_CASES:
        args = k2_inputs(gen, bsz, p, n, kind, dev)
        out = pw.q8f_fused(*args)
        ref = pw.factored_classify_q8_fused_plain(*args)
        torch.cuda.synchronize()
        if out.shape != (bsz, p, NUM_PREDICATES) or not torch.isfinite(out).all():
            raise AssertionError(f"q8f_fused {name}: bad output {tuple(out.shape)}")
        err = (out - ref).abs().max().item()
        if not torch.equal(out, ref):
            raise AssertionError(f"q8f_fused {name}: kernel != plain, max |err| {err}")
        ms = cuda_median_ms(lambda: pw.q8f_fused(*args))
        plain_ms = cuda_median_ms(lambda: pw.factored_classify_q8_fused_plain(*args))
        d = args[0].shape[-1]
        report[name] = {"segments": bsz, "rows": p, "tracklets": n, "pairs": kind,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        **bound(args, out, 2.0 * bsz * p * d * NUM_PREDICATES, "int8")}
        log(f"q8f_fused {name}: {bsz} x {p} rows, N={n}, {kind} pairs, equal=True "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"bound {report[name]['bound_ms']:.4f} ms ({report[name]['bound_by']}, "
            f"{report[name]['bytes'] / 1e6:.2f} MB)")
    return report


def ppn_params(rng) -> dict:
    """The flax PPNHead's Dense layers, (in, out) kernels drawn with
    lecun-normal scale, zero biases."""
    import numpy as np

    def dense(fan_in, fan_out):
        return {"kernel": (rng.normal(0, 1, (fan_in, fan_out)) / np.sqrt(fan_in)
                           ).astype(np.float32),
                "bias": np.zeros(fan_out, np.float32)}

    c = SERVE["num_objects"]
    return {f"{role}_fc{k}": dense(*shape) for role in ("sub", "obj")
            for k, shape in ((1, (c, PPN_HIDDEN)), (2, (PPN_HIDDEN, PPN_OUT)))}


def seeded_model(dev, ppn: bool = False, dtype=torch.float32):
    """normal(0.01) classifier init from a numpy seed (and the PPN head's,
    with ``ppn``), carried across from the JAX param-tree layout as a JAX
    checkpoint would be; ``dtype`` is the compute dtype."""
    import numpy as np

    from tspn_tpu_torch.models.tspn import build_model
    from tspn_tpu_torch.runtime.checkpoint import state_dict_from_jax

    rng = np.random.RandomState(SEED)
    params = {"classifier": {"rel_predictor": {
        "kernel": rng.normal(0, 0.01, (FEATURE_DIM, NUM_PREDICATES)).astype(np.float32),
        "bias": np.zeros(NUM_PREDICATES, np.float32),
    }}}
    if ppn:
        params["ppn_head"] = ppn_params(rng)
    model = build_model(NUM_PREDICATES, FEATURE_DIM, use_ppn=ppn,
                        ppn_hidden=PPN_HIDDEN, ppn_out=PPN_OUT, dtype=dtype)
    model.load_state_dict(state_dict_from_jax(params))
    return model.to(dev).eval()


def seeded_fused_model(dev, inference: bool, ppn: bool = False, dtype=torch.float32):
    """The fused classifier's normal(0.01) init (device-layout kernel,
    zero bias), and the PPN head's with ``ppn``, from a numpy seed,
    carried across from the JAX param-tree layout."""
    import numpy as np

    from tspn_tpu_torch.data.layout import DEFAULT_LAYOUT
    from tspn_tpu_torch.models.tspn import build_model
    from tspn_tpu_torch.runtime.checkpoint import state_dict_from_jax

    rng = np.random.RandomState(SEED + 1)
    params = {"classifier": {
        "kernel": rng.normal(0, 0.01, (DEFAULT_LAYOUT.device_dim, NUM_PREDICATES)
                             ).astype(np.float32),
        "bias": np.zeros(NUM_PREDICATES, np.float32),
    }}
    if ppn:
        params["ppn_head"] = ppn_params(rng)
    model = build_model(NUM_PREDICATES, fused_classifier=True, inference=inference,
                        use_ppn=ppn, num_objects=SERVE["num_objects"],
                        ppn_hidden=PPN_HIDDEN, ppn_out=PPN_OUT, dtype=dtype)
    model.load_state_dict(state_dict_from_jax(params))
    return model.to(dev)


def selection(out: dict) -> dict:
    """segment -> its top-k entries sorted by (-score, pair, pred)."""
    return {
        key: sorted(
            (-float(s), int(t[0]), int(t[1]), int(trip[1]))
            for s, trip, t in preds
        )
        for key, (preds, _iou, _tid) in out.items()
    }


def same_selection(kernel: dict, plain: dict) -> int:
    """Exact equality of two runs' selections -> 0 ties excluded."""
    if kernel != plain:
        diff = [k for k in kernel if kernel[k] != plain.get(k)]
        raise AssertionError(f"top-k differs from plain in {diff[:5]}")
    return 0


def same_selection_but_ties(kernel: dict, plain: dict, tie_tol: float = TIE_TOL) -> int:
    """Selections equal apart from near-ties at the cut: sorted scores
    agree within ``tie_tol``, and an entry that only one run selected must
    score within ``tie_tol`` of the other run's last selected entry (it lost
    a tie there). -> the number of such entries."""
    if set(kernel) != set(plain):
        raise AssertionError("kernel and plain served different segments")
    swapped = 0
    for key in kernel:
        a, b = kernel[key], plain[key]
        if len(a) != len(b):
            raise AssertionError(f"{key}: {len(a)} vs {len(b)} selections")
        gap = max((abs(x[0] - y[0]) for x, y in zip(a, b)), default=0.0)
        if gap > tie_tol:
            raise AssertionError(f"{key}: sorted scores differ by {gap}")
        sa = {e[1:]: -e[0] for e in a}
        sb = {e[1:]: -e[0] for e in b}
        for only, mine, other in ((sa.keys() - sb.keys(), sa, sb),
                                  (sb.keys() - sa.keys(), sb, sa)):
            cut = min(other.values())
            for e in only:
                if mine[e] - cut > tie_tol:
                    raise AssertionError(
                        f"{key}: {e} scores {mine[e]}, above the other run's "
                        f"cut {cut} by more than {tie_tol}"
                    )
        swapped += len(sa.keys() ^ sb.keys())
    return swapped


def check_output(out: dict, dataset) -> None:
    """Every segment of >= 2 tracklets has min(200, 20 P) finite
    probabilities with in-range tracklet ids (PPN pruning keeps
    min(256, P) rows, which leaves that count as it is)."""
    expected = {r.index: r for r in dataset.records if r.num_proposals > 1}
    if set(out) != set(expected):
        raise AssertionError("served segments differ from the dataset's")
    for key, (preds, _iou, _tid) in out.items():
        n = expected[key].num_proposals
        want = min(SERVE["topk_per_seg"], n * (n - 1) * SERVE["topk_per_pair"])
        if len(preds) != want:
            raise AssertionError(f"{key}: {len(preds)} predictions, want {want}")
        for score, trip, tids in preds:
            if not (0.0 <= score <= 1.0) or tids.min() < 0 or tids.max() >= n:
                raise AssertionError(f"{key}: bad entry {score} {trip} {tids}")
            if not 0 <= trip[1] < NUM_PREDICATES:
                raise AssertionError(f"{key}: bad predicate {trip}")


def phase_serve(label: str, dataset, model, dev, launches_per_batch: dict,
                compare=same_selection, **extra) -> dict:
    """predict_segments with the kernels and with the plain versions, and
    the kernels at pipeline_depth 2 (the default) and 0, in turns
    (SERVE_TURNS), after one untimed run of each variant; then one
    traced kernel run at each depth (its host-to-device copies summed
    apart). Every kernel run selects the same top-k, at either depth.
    ``launches_per_batch`` maps each kernel to its launches per batch;
    ``extra`` goes to predict_segments (PPN pruning)."""
    from tspn_tpu_torch.data.loader import BucketedLoader
    from tspn_tpu_torch.ops import pairwise as pw
    from tspn_tpu_torch.runtime.predict import predict_segments

    serve = dict(SERVE, **extra)
    loader = BucketedLoader(dataset, SERVE["buckets"], SERVE["batch_size"],
                            dataset.feature_width(), SERVE["num_objects"],
                            feats_dtype=model.compute_dtype, prefetch=0)
    t0 = time.perf_counter()
    padded = sum(batch["feats"].shape[0] * batch["feats"].shape[1]
                 for _b, batch, _i, _r in loader)
    loader_s = time.perf_counter() - t0
    n_batches = len(loader)
    rows = sum(r.feats.shape[0] for r in dataset.records)
    feat_bytes = sum(r.feats.size for r in dataset.records) * (
        2 if model.compute_dtype == torch.bfloat16 else dataset.records[0].feats.itemsize)
    log(f"serve {label}: {len(dataset)} segments, {rows} pairs "
        f"({padded} rows with padding), {feat_bytes / 1e9:.3f} GB of "
        f"pair rows, {n_batches} batches; batch assembly alone {loader_s:.3f} s")

    def run(variant, depth):
        return predict_segments(model, dataset, device=dev, plain=variant == "plain",
                                pipeline_depth=depth, **serve)

    for variant in ("plain", "kernel"):  # warm-up, untimed
        run(variant, 2)
    runs = {"plain": [], "kernel": [], "kernel_depth0": []}
    outs = {}
    for variant, depth in SERVE_TURNS:
        before = dict(pw.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(variant, depth)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        for kernel, per_batch in launches_per_batch.items():
            launched = pw.LAUNCHES[kernel] - before[kernel]
            want = per_batch * n_batches if variant == "kernel" else 0
            if launched != want:
                raise AssertionError(
                    f"serve {label} {variant} depth {depth}: {launched} {kernel} "
                    f"launches, want {want}"
                )
        check_output(out, dataset)
        runs[variant + ("_depth0" if depth == 0 else "")].append(len(dataset) / seconds)
        outs.setdefault(variant, selection(out))
        if selection(out) != outs[variant]:
            raise AssertionError(f"serve {label} {variant} depth {depth}: runs disagree")
    try:
        ties = compare(outs["kernel"], outs["plain"])
    except AssertionError as exc:
        raise AssertionError(f"serve {label}: {exc}") from None
    prof = {f"depth{depth}": traced_run(f"serve {label} depth {depth}",
                                        lambda: run("kernel", depth), watch=(COPY,))
            for depth in (2, 0)}
    result = {"batches": n_batches, "pairs": rows, "rows_with_padding": padded,
              "feature_bytes": feat_bytes, "loader_s": loader_s,
              "near_ties_excluded": ties,
              "segments_per_s": statistics.median(runs["kernel"]),
              "depth0_segments_per_s": statistics.median(runs["kernel_depth0"]),
              "plain_segments_per_s": statistics.median(runs["plain"]),
              "runs": runs, "profile": prof}
    log(f"serve {label}: top-k equal to plain in all {len(outs['kernel'])} "
        f"segments ({ties} near-tie entries excluded), and at pipeline_depth 2 and 0; "
        f"launches per batch {launches_per_batch}; segments/s kernel, depth 2 "
        f"{runs['kernel']}, depth 0 {runs['kernel_depth0']}; plain {runs['plain']}; "
        f"busy share depth 2 {prof['depth2']['device_busy_share']}, depth 0 "
        f"{prof['depth0']['device_busy_share']}")
    log(f"serve {label} profile: {json.dumps(prof)}")
    return result


def raw_device_rows(p: int, zero_rows: int, gen, dev):
    """(p, 11264) f32 device-layout rows as the fused path reads them: a
    normal head, sparse BoW counts in each block's 1000 columns (slot
    padding zero), block 0 of row 0 all zero, and ``zero_rows`` zero
    padding rows at the end."""
    from tspn_tpu_torch.data.layout import DEFAULT_LAYOUT as lo

    x = torch.zeros((p, lo.device_dim), device=dev)
    x[:, : lo.dev_head_dim] = torch.randn((p, lo.dev_head_dim), generator=gen, device=dev)
    for k in range(lo.num_bow_blocks):
        s = lo.dev_head_pad + k * lo.dev_block
        counts = torch.randint(1, 6, (p, lo.bow_block_size), generator=gen, device=dev)
        hit = torch.rand((p, lo.bow_block_size), generator=gen, device=dev) < 0.02
        x[:, s : s + lo.bow_block_size] = (counts * hit).float()
    x[0, lo.dev_head_pad : lo.dev_head_pad + lo.dev_block] = 0
    if zero_rows:
        x[-zero_rows:] = 0
    return x


def phase_fused_check(dev) -> dict:
    """fused_classify vs its plain version within the stated bound."""
    from tspn_tpu_torch.data.layout import DEFAULT_LAYOUT as lo
    from tspn_tpu_torch.ops import pairwise as pw

    gen = torch.Generator(device=dev).manual_seed(SEED)
    w = torch.randn((lo.device_dim, NUM_PREDICATES), generator=gen, device=dev) * 0.01
    b = torch.randn((NUM_PREDICATES,), generator=gen, device=dev)
    report = {}
    for name, p, zero_rows in FUSED_CASES:
        x = raw_device_rows(p, zero_rows, gen, dev)
        out = pw.normalize_classify_fused_forward(x, w, b, lo)
        ref = pw.normalize_classify_fused_plain(x, w, b, lo)
        torch.cuda.synchronize()
        if out.shape != (p, NUM_PREDICATES) or not torch.isfinite(out).all():
            raise AssertionError(f"fused_classify {name}: bad output {tuple(out.shape)}")
        xn = pw._normalize_device_layout(x.double(), lo).abs()
        tol = 1e-5 * (xn @ w.double().abs() + b.double().abs()) + 1e-6
        del xn
        err = (out.double() - ref.double()).abs()
        worst = float((err / tol).max())
        max_err = float(err.max())
        if worst > 1.0:
            raise AssertionError(
                f"fused_classify {name}: |kernel - plain| exceeds the bound "
                f"(max err {max_err}, worst err/bound {worst})"
            )
        again = pw.normalize_classify_fused_forward(x, w, b, lo)
        if not torch.equal(out, again):
            raise AssertionError(f"fused_classify {name}: two runs differ")
        ms = cuda_median_ms(lambda: pw.normalize_classify_fused_forward(x, w, b, lo))
        plain_ms = cuda_median_ms(lambda: pw.normalize_classify_fused_plain(x, w, b, lo))
        # the weights' TF32 halves, which every call prepares (part of ms)
        prep_ms = cuda_median_ms(lambda: pw._tf32_weights(w))
        # the yardstick (never called by the port): cuBLAS SGEMM of rows
        # normalized beforehand, TF32 off
        xn = pw._normalize_device_layout(x, lo)
        library_ms = cuda_median_ms(lambda: torch.matmul(xn, w))
        del xn
        plan = pw.fused_plan(p, NUM_PREDICATES, lo, torch.cuda.get_device_properties(dev)
                             .multi_processor_count)
        flop = 2.0 * p * lo.device_dim * NUM_PREDICATES
        # an f32-accurate product on the tensor cores: three TF32 passes
        tf32 = bound((x, w, b), out, {"tf32": 3 * flop})
        cuda_cores = bound((x, w, b), out, flop, "f32")
        report[name] = {"rows": p, "width": lo.device_dim, "cols": NUM_PREDICATES,
                        "max_abs_err": max_err, "worst_err_over_bound": worst,
                        "ms": ms, "plain_ms": plain_ms, "prep_ms": prep_ms,
                        "library_ms": library_ms,
                        "plan": {"tiles": plan.tiles, "pieces": [
                            [plan.units[a][0] * pw.FUSED_CHUNK, plan.units[e - 1][1] * pw.FUSED_CHUNK]
                            for a, e in plan.pieces], "blocks": plan.blocks},
                        "kernel_tflops": flop / ms / 1e9,
                        "plain_tflops": flop / plain_ms / 1e9,
                        "f32_cuda_core_bound_ms": cuda_cores["bound_ms"],
                        "pct_of_bound": 100.0 * tf32["bound_ms"] / ms, **tf32}
        log(f"fused_classify {name}: P={p} D={lo.device_dim} R={NUM_PREDICATES} "
            f"max|err| {max_err:.3e} (worst err/bound {worst:.3f}) "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms SGEMM (yardstick) {library_ms:.4f} ms "
            f"prep {prep_ms:.4f} ms; plan {plan.tiles} tiles x {len(plan.pieces)} pieces "
            f"{report[name]['plan']['pieces']}; bound {tf32['bound_ms']:.4f} ms "
            f"({tf32['bound_by']}, three TF32 passes; {report[name]['pct_of_bound']:.1f}%), "
            f"f32 CUDA-core bound {cuda_cores['bound_ms']:.4f} ms")
        del x, out, ref, err, tol, again
    return report


def phase_train(label: str, dataset, dev, ppn: bool = False,
                dtype=torch.float32, rtol=(1e-4, 1e-3)) -> dict:
    """Fused training (with the PPN head and its loss under ``ppn``; in
    ``dtype``) from the same init in turns, plain, kernel, kernel, plain,
    so neither side always runs first on a shared host; then a shorter
    traced kernel run. Each kernel run's step-1 losses agree with the
    first plain run's to rtol ``rtol[0]``, every step to ``rtol[1]``, for
    the total and for each loss term; the last total loss is below the
    first. The rates are the mean of each side's two runs."""
    from tspn_tpu_torch.ops import pairwise as pw
    from tspn_tpu_torch.runtime.train import train_segments

    kernel = "fused_classify_bf16" if dtype == torch.bfloat16 else "fused_classify"

    def run(plain: bool, steps: int):
        model = seeded_fused_model(dev, inference=False, ppn=ppn, dtype=dtype)
        before = pw.LAUNCHES[kernel]
        result = train_segments(model, dataset, solver=SOLVER, max_iter=steps,
                                device=dev, plain=plain, **TRAIN)
        launched = pw.LAUNCHES[kernel] - before
        want = 0 if plain else steps
        if launched != want or result.step != steps:
            raise AssertionError(
                f"train {label} {'plain' if plain else 'kernel'}: {launched} "
                f"launches over {result.step} steps, want {want} over {steps}"
            )
        return result

    runs = {"plain": [], "kernel": []}
    for plain in (True, False, False, True):
        runs["plain" if plain else "kernel"].append(run(plain, TRAIN_STEPS))
    plain_run = runs["plain"][0]
    max_rel = {}
    for kernel_run in runs["kernel"]:
        series = {"loss": (kernel_run.losses, plain_run.losses)}
        for term in kernel_run.loss_terms:
            series[term] = (kernel_run.loss_terms[term], plain_run.loss_terms[term])
        if ppn and set(series) != {"loss", "loss_rel", "loss_pair"}:
            raise AssertionError(f"train {label}: loss terms {sorted(series)}")
        for name, (lk, lp) in series.items():
            rel = [abs(a - b) / abs(b) for a, b in zip(lk, lp)]
            if len(rel) != TRAIN_STEPS or rel[0] > rtol[0] or max(rel) > rtol[1]:
                raise AssertionError(f"train {label}: kernel {name} {lk} vs plain {lp}")
            max_rel[name] = max(max_rel.get(name, 0.0), max(rel))
    lk, lp = series["loss"]
    if not (lk[-1] < lk[0] and lp[-1] < lp[0]):
        raise AssertionError(f"train {label}: the loss did not fall: {lk}")
    prof = traced_run(f"train {label}", lambda: run(False, PROFILED_STEPS), watch=(COPY,))
    report = {"steps": TRAIN_STEPS, "batch": TRAIN["batch_size"],
              "losses_kernel": {k: v[0] for k, v in series.items()},
              "losses_plain": {k: v[1] for k, v in series.items()},
              "max_rel_loss_diff": max_rel, "profile_steps": PROFILED_STEPS,
              "profile": prof}
    for name, rs in runs.items():
        rates = [r.step / r.seconds for r in rs]
        report[f"{name}_steps_per_s_runs"] = rates
        report[f"{name}_steps_per_s"] = sum(rates) / len(rates)
        report[f"{name}_segments_per_s"] = report[f"{name}_steps_per_s"] * TRAIN["batch_size"]
    terms = ", ".join(f"{k} {v[0][0]:.5f} -> {v[0][-1]:.5f}" for k, v in series.items())
    log(f"train {label}: {TRAIN_STEPS} steps, {terms} (max rel diff to plain "
        f"{json.dumps(max_rel)}); steps/s kernel {report['kernel_steps_per_s']:.3f} "
        f"{[round(x, 3) for x in report['kernel_steps_per_s_runs']]} plain "
        f"{report['plain_steps_per_s']:.3f} "
        f"{[round(x, 3) for x in report['plain_steps_per_s_runs']]}")
    log(f"train {label} profile ({PROFILED_STEPS} steps): {json.dumps(prof)}")
    return report


def roi_align_plain_chunked(feats, boxes, batch_idx, output_size, sampling_ratio):
    """roi_align_plain over PLAIN_CHUNK RoIs at a time (its gather form's
    (R, out*s, W, C) intermediate is 9.4 GB at 2048 RoIs of a 40-wide,
    1024-channel map); the signature of FasterRCNN.roi_pool."""
    from tspn_tpu_torch.ops import roi_align as ra

    return torch.cat([
        ra.roi_align_plain(feats, boxes[k : k + PLAIN_CHUNK],
                           batch_idx[k : k + PLAIN_CHUNK], output_size, sampling_ratio)
        for k in range(0, boxes.shape[0], PLAIN_CHUNK)
    ])


def k7_inputs(gen, n, h, w, c, r, kind, dev):
    """Channels-last features in [0, 1), boxes in feature coordinates and
    the image of each box: the boundary boxes on image 0, or r boxes drawn
    over the map (some hanging off each edge) spread in order over the n
    images, as a detect batch lays them out."""
    feats = torch.rand((n, h, w, c), generator=gen, device=dev)
    if kind == "border":
        boxes = torch.tensor(BORDER_BOXES, device=dev)
    elif kind == "train":  # GT-like boxes inside the map, then proposals
        inside = r // 2
        xy = torch.rand((inside, 2), generator=gen, device=dev) * torch.tensor(
            [w - 4.0, h - 4.0], device=dev)
        wh = torch.rand((inside, 2), generator=gen, device=dev) * 20.0 + 1.0
        gt = torch.cat([xy, torch.minimum(xy + wh, torch.tensor([w, h], device=dev))], 1)
        _, rest, _ = k7_inputs(gen, 1, h, w, 1, r - inside, "random", dev)
        boxes = torch.cat([gt, rest])[torch.randperm(r, generator=gen, device=dev)]
    else:
        xy = torch.rand((r, 2), generator=gen, device=dev) * torch.tensor(
            [w + 8.0, h + 8.0], device=dev) - 4.0
        wh = torch.rand((r, 2), generator=gen, device=dev) * 30.0 + 0.25
        boxes = torch.cat([xy, xy + wh], dim=1)
    batch_idx = (torch.arange(r, device=dev) * n // r).to(torch.int32)
    return feats, boxes.contiguous(), batch_idx


def phase_k7_check(dev) -> dict:
    """K7 vs roi_align_plain (in chunks), bit for bit."""
    from tspn_tpu_torch.ops import roi_align as ra

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    report = {}
    for name, n, h, w, c, r, out, s, kind in K7_CASES:
        feats, boxes, idx = k7_inputs(gen, n, h, w, c, r, kind, dev)
        got = ra.roi_align(feats, boxes, idx, out, s)
        ref = roi_align_plain_chunked(feats, boxes, idx, out, s)
        torch.cuda.synchronize()
        if got.shape != (r, out, out, c) or not torch.isfinite(got).all():
            raise AssertionError(f"roi_align {name}: bad output {tuple(got.shape)}")
        max_err = float((got - ref).abs().max())
        if not torch.equal(got, ref):
            raise AssertionError(f"roi_align {name}: K7 differs from plain (max err {max_err})")
        del ref
        ms = cuda_median_ms(lambda: ra.roi_align(feats, boxes, idx, out, s))
        plain_ms = cuda_median_ms(
            lambda: roi_align_plain_chunked(feats, boxes, idx, out, s), iters=3)
        report[name] = {"images": n, "map": [h, w, c], "rois": r, "out": out,
                        "sampling_ratio": s, "max_abs_err": max_err, "ms": ms,
                        "plain_ms": plain_ms,
                        **bound((feats, boxes, idx), got, k7_ops(s, got.numel()), "f32")}
        log(f"roi_align {name}: {n} x {h}x{w}x{c}, {r} RoIs, out {out}, s {s}, "
            f"{ra._vec(c, feats)} channels a thread: equal to plain; kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms bound {report[name]['bound_ms']:.4f} ms "
            f"({report[name]['bound_by']}, {report[name]['bytes'] / 1e9:.3f} GB)")
        del feats, boxes, idx, got
    return report


def seeded_detector(dev, dtype=torch.float32, state_dict=None):
    """Faster R-CNN R101-C4 at DetectionConfig's defaults with the flax-like
    seeded init (or ``state_dict``), computing in ``dtype``; the cls_score
    bias of classes 0..2 is raised to 3, so those classes score about 0.2
    against the 0.05 threshold (a seeded init alone scores every class
    near 1/36 and keeps nothing)."""
    from tspn_tpu_torch.detection.rcnn import DetectionConfig, FasterRCNN

    model = FasterRCNN(DetectionConfig(), generator=torch.Generator().manual_seed(SEED),
                       dtype=dtype)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    with torch.no_grad():
        model.cls_score.bias[:DET_RAISED_CLASSES] = DET_RAISED_BIAS
    return model.to(dev).to(memory_format=torch.channels_last).eval()


def synthetic_frames(n: int, seed: int):
    """(n, 640, 640, 3) float32 frames in [0, 1]: dim noise with six flat
    coloured rectangles each."""
    import numpy as np

    rng = np.random.RandomState(seed)
    frames = (rng.rand(n, DET_SIZE, DET_SIZE, 3) * 0.25).astype(np.float32)
    for t in range(n):
        for _ in range(6):
            y0, x0 = rng.randint(0, DET_SIZE - 64, 2)
            hh, ww = rng.randint(32, 320, 2)
            frames[t, y0 : y0 + hh, x0 : x0 + ww] = rng.rand(3)
    return frames


def check_detections(dets: dict, n: int, num_classes: int) -> int:
    """Fixed-size detections of n frames: every frame keeps some; kept
    boxes are finite and inside the frame, classes in range, scores in
    (0.05, 1]; dropped slots score 0. -> the number kept."""
    mask = torch.as_tensor(dets["mask"]).bool()
    boxes = torch.as_tensor(dets["boxes"])
    scores = torch.as_tensor(dets["scores"])
    classes = torch.as_tensor(dets["classes"])
    if mask.shape[0] != n or not bool(mask.any(dim=1).all()):
        raise AssertionError(f"frames without detections: {(~mask.any(dim=1)).sum()} of {n}")
    kb = boxes[mask]
    if not (torch.isfinite(kb).all() and kb.min() >= 0 and kb.max() <= DET_SIZE):
        raise AssertionError("detected boxes outside the frame")
    ks, kc = scores[mask], classes[mask]
    if not ((ks > 0.05).all() and (ks <= 1).all() and (kc >= 0).all()
            and (kc < num_classes).all() and not scores[~mask].any()):
        raise AssertionError("bad detection scores or classes")
    return int(mask.sum())


def same_detections_but_ties(kernel: dict, plain: dict) -> int:
    """Per image, slot by slot: the same class, box (atol 1e-3 px) and score
    (within DET_TIE); a slot may differ only where the plain score lies
    within DET_TIE of a neighbour's and the kernel's slot scores within
    DET_TIE of it (a near-tie broken the other way). -> such slots."""
    if not torch.equal(kernel["mask"], plain["mask"]):
        raise AssertionError("K7 and plain keep different numbers of detections")
    swapped = 0
    for b in range(plain["mask"].shape[0]):
        kept = torch.nonzero(plain["mask"][b])[:, 0]
        ps = plain["scores"][b]
        for k in kept.tolist():
            close = abs(float(kernel["scores"][b, k] - ps[k])) <= DET_TIE
            if (close and int(kernel["classes"][b, k]) == int(plain["classes"][b, k])
                    and torch.allclose(kernel["boxes"][b, k], plain["boxes"][b, k],
                                       rtol=1e-5, atol=1e-3)):
                continue
            gap = float((ps[kept] - ps[k]).abs().sort().values[1])
            if not (close and gap <= DET_TIE):
                raise AssertionError(f"image {b} slot {k}: K7 and plain differ")
            swapped += 1
    return swapped


def traced_run(label: str, fn, watch: tuple = ()) -> dict:
    """``fn()`` once in the benchmark's traced window (its device work
    waited for inside it), reduced by ``benchmark.trace.DeviceTrace``: the
    window, the device's busy time (the union of its activities), the
    summed device time, the largest device entries, the summed device time
    of the entries whose name holds each string of ``watch``, and the
    port's spans (``benchmark.spans.summary``), which are logged. The
    busy share is the union of device activity over the window, as the
    benchmark's ``device_idle_share`` reads it."""
    from benchmark.spans import summary
    from benchmark.trace import DeviceTrace, Tracer

    tracer = Tracer(True)
    with tracer.window():
        fn()
        torch.cuda.synchronize()
    dt = DeviceTrace.from_profiler(tracer.prof)
    spans = summary(dt)
    if spans:
        log(f"{label} spans (count, host s, self s, device idle s inside):")
    for name, row in spans.items():
        log(f"  {name:<18} {row['count']:6d} {row['host_s']:9.4f} {row['self_s']:9.4f} "
            f"{row['idle_s']:9.4f}")
    device_ms = dt.device_s(lambda name, op: True) * 1e3
    return {"wall_s": dt.window_s, "device_ms": device_ms,
            "device_busy_share": dt.busy_s() / dt.window_s,
            "top_device_ms": [[k, v * 1e3] for k, v in dt.device_ops(6)],
            "watched_device_ms": {w: dt.device_s(lambda name, op, w=w: w in name) * 1e3
                                  for w in watch},
            "spans": spans}


def phase_detect(dev, dtype=torch.float32) -> dict:
    """Detector inference at full width through detect_video_frames, with
    K7 and with the plain RoIAlign in turns; the K7-vs-plain detections on
    shared features; one TTA batch, one classeme call, one traced run.
    A bf16 model runs K7's bf16 half."""
    from tspn_tpu_torch.ops import roi_align as ra
    from tspn_tpu_torch.pipeline import detect_video_frames

    label = "detect" if dtype == torch.float32 else "detect bf16"
    key = "roi_align" if dtype == torch.float32 else "roi_align_bf16"
    t0 = time.perf_counter()
    model = seeded_detector(dev, dtype)
    frames = synthetic_frames(DET_FRAMES, SEED)
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = model.cfg
    n_batches = -(-DET_FRAMES // DET_BATCH)
    log(f"{label}: R{cfg.depth}-C4, {cfg.num_classes} classes, {DET_FRAMES} frames of "
        f"{DET_SIZE}x{DET_SIZE}, batch {DET_BATCH} ({n_batches} batches); model and "
        f"frames made in {setup_s:.1f} s")

    def run(variant: str):
        model.roi_pool = ra.roi_align if variant == "kernel" else roi_align_plain_chunked
        before = ra.LAUNCHES[key]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = detect_video_frames(model, frames, device=dev, batch_size=DET_BATCH)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        model.roi_pool = ra.roi_align
        launched = ra.LAUNCHES[key] - before
        want = n_batches if variant == "kernel" else 0
        if launched != want:
            raise AssertionError(f"{label} {variant}: {launched} {key} launches, "
                                 f"want {want}")
        return dets, seconds

    for variant in ("plain", "kernel"):  # warm-up, untimed
        run(variant)
    runs = {"plain": [], "kernel": []}
    kept = None
    for variant in ("plain", "kernel", "kernel", "plain"):
        dets, seconds = run(variant)
        kept = check_detections(dets, DET_FRAMES, cfg.num_classes)
        runs[variant].append(DET_FRAMES / seconds)

    images = torch.as_tensor(frames[:DET_BATCH], device=dev)
    with torch.no_grad():
        feats = model.features(images)
        kernel = model.detect_from_features(feats, (DET_SIZE, DET_SIZE))
        model.roi_pool = roi_align_plain_chunked
        try:
            plain = model.detect_from_features(feats, (DET_SIZE, DET_SIZE))
        finally:
            model.roi_pool = ra.roi_align
        ties = same_detections_but_ties(kernel, plain)
        tta = model.detect_tta(images)
        tta_kept = check_detections(tta, DET_BATCH, cfg.num_classes)
        classeme = model.roi_classeme(images, kernel["boxes"])
    torch.cuda.synchronize()
    if classeme.shape != (DET_BATCH, cfg.max_detections, cfg.num_classes + 1) or not bool(
            torch.isfinite(classeme).all()):
        raise AssertionError(f"roi_classeme: bad output {tuple(classeme.shape)}")
    del feats, classeme
    prof = traced_run(
        label, lambda: detect_video_frames(model, frames, device=dev, batch_size=DET_BATCH),
        watch=("roi_align",))
    k7_ms = prof["watched_device_ms"]["roi_align"]
    timed_s = DET_FRAMES / statistics.median(runs["kernel"])
    result = {"dtype": str(dtype), "frames": DET_FRAMES, "batch": DET_BATCH, "size": DET_SIZE,
              "batches": n_batches, "kept_detections": kept,
              "tta_kept_detections": tta_kept, "near_ties_excluded": ties,
              "frames_per_s": statistics.median(runs["kernel"]),
              "plain_frames_per_s": statistics.median(runs["plain"]), "runs": runs,
              "k7_device_ms": k7_ms,
              "k7_share_of_device": k7_ms / prof["device_ms"] if prof["device_ms"] else None,
              # the profiler slows the host's launches; the device time over
              # an unprofiled pass's wall is the nearer busy share
              "device_busy_share_unprofiled": prof["device_ms"] / (timed_s * 1e3),
              "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
              "profile": prof,
              # warm-up, two timed kernel runs and the traced run: one
              # launch per batch each; the shared-features detect, TTA and
              # classeme once
              "want_launches": 4 * n_batches + 3,
              # NMS, two calls a batch (RPN, class-aware) in every run,
              # plain RoIAlign's too: six runs and the traced one; the two
              # shared-features detects; TTA's detect and its merge
              "want_nms_launches": 2 * 7 * n_batches + 2 * 2 + 3}
    log(f"{label}: {kept} detections kept over {DET_FRAMES} frames, every frame "
        f"keeps some; K7 and plain on shared features equal apart from {ties} "
        f"near-tie slots; TTA keeps {tta_kept}; frames/s kernel {runs['kernel']} "
        f"plain {runs['plain']}")
    log(f"{label} profile: {json.dumps(prof)}")
    return result


def variant_inputs(gen, lo, p: int, dev) -> dict:
    """Operands of K4, K5, K6 and the probe over one set of int8 rows in
    [-128, 127]: the last 50 rows all zero, BoW block 1 of every 7th row
    and block 7 of every 11th row empty; head scales; K1's (P, 16) scales
    of those rows and the transposed copies; int8 weights (R 132), bf16
    weights (normal(0.01), rounded) and the probe's int8 (160, D) weights."""
    from tspn_tpu_torch.ops import pairwise as pw

    d, hp, blk, r = lo.device_dim, lo.dev_head_pad, lo.dev_block, NUM_PREDICATES
    q = torch.randint(-128, 128, (p, d), generator=gen, device=dev, dtype=torch.int8)
    q[-50:] = 0
    q[::7, hp + blk : hp + 2 * blk] = 0
    q[1::11, hp + 7 * blk :] = 0
    hs = torch.rand((p,), generator=gen, device=dev) / 64
    scales = pw.q8_block_scales(q, hs, lo)
    return {
        "q": q, "hs": hs, "scales": scales, "xt": q.T.contiguous(),
        "scales_t": scales.T.contiguous(),
        "qw_t": torch.randint(-127, 128, (r, d), generator=gen, device=dev, dtype=torch.int8),
        "sw": torch.rand((r,), generator=gen, device=dev) / 127,
        "b": torch.randn((r,), generator=gen, device=dev),
        "w_bf16_t": pw.weights_bf16_t(torch.randn((d, r), generator=gen, device=dev) * 0.01),
        "w_probe": torch.randint(-128, 128, (PROBE_ROWS, d), generator=gen, device=dev,
                                 dtype=torch.int8),
    }


def in_chunks(p: int, dim: int, fn):
    """``fn(rows)`` over slices of VARIANT_CHUNK rows, joined along ``dim``."""
    return torch.cat([fn(slice(a, a + VARIANT_CHUNK)) for a in range(0, p, VARIANT_CHUNK)],
                     dim=dim)


def k5_worst_over_bound(t: dict, out, ref, lo) -> float:
    """max |K5 - plain| / (1e-5 (|q_h| @ |w_h| s + sum_k |q_k| @ |w_k| / L1_k
    + |b|) + 1e-6), in float64, a chunk of rows at a time."""
    hp, nb, blk = lo.dev_head_pad, lo.num_bow_blocks, lo.dev_block
    wa = t["w_bf16_t"].double().abs()
    worst = 0.0
    for a in range(0, out.shape[0], VARIANT_CHUNK):
        rows = slice(a, a + VARIANT_CHUNK)
        qa = t["q"][rows].double().abs()
        s = t["scales"][rows].double()
        terms = (qa[:, :hp] @ wa[:, :hp].T) * s[:, :1]
        for k in range(nb):
            c = slice(hp + k * blk, hp + (k + 1) * blk)
            terms += (qa[:, c] @ wa[:, c].T) * s[:, k + 1 : k + 2]
        tol = 1e-5 * (terms + t["b"].double().abs()) + 1e-6
        err = (out[rows].double() - ref[rows].double()).abs()
        worst = max(worst, float((err / tol).max()))
    return worst


def probe_entry(x, w, dev) -> dict:
    """The probe on x (D, P), w (R, D): every mode equal to its plain version
    (run in chunks of pairs) bit for bit; onedot timed beside its plain
    version, its bound and torch._int_mm where that takes the shapes; the
    kernel's plan."""
    from tspn_tpu_torch.ops import pairwise as pw

    d, p = x.shape
    err = 0
    for mode in pw.PROBE_MODES:
        out = pw.pair_probe(x, w, mode)
        ref = in_chunks(p, 1, lambda s: pw.pair_probe_plain(x[:, s], w, mode))
        torch.cuda.synchronize()
        err = max(err, int((out.long() - ref.long()).abs().max()))
        if out.shape != (w.shape[0], p) or not torch.equal(out, ref):
            raise AssertionError(f"q8_probe P={p} D={d} {mode}: kernel != plain (max |err| {err})")
        del ref
    onedot = lambda: pw.pair_probe(x, w, "onedot")
    plan = pw.probe_plan(p, w.shape[0], d, "onedot",
                         torch.cuda.get_device_properties(dev).multi_processor_count)
    entry = {"rows": p, "width": d, "cols": w.shape[0], "modes": list(pw.PROBE_MODES),
             "max_abs_err": err, "ms": cuda_median_ms(onedot),
             "plain_ms": cuda_median_ms(lambda: in_chunks(p, 1, lambda s: pw.pair_probe_plain(
                 x[:, s], w, "onedot")), iters=3),
             **bound((x, w), out, 2.0 * w.shape[0] * d * p, "int8"),
             "staging": plan.staging, "split": plan.split, "grid": plan.grid,
             "library_ms": None}
    try:  # one PyTorch call of the same product, never used by the port
        lib = torch._int_mm(w, x)
        torch.cuda.synchronize()
        entry["library_equal"] = torch.equal(lib, out)
        entry["library_ms"] = cuda_median_ms(lambda: torch._int_mm(w, x))
        del lib
    except RuntimeError as exc:
        entry["library_refused"] = str(exc)[:300]
    return entry


def log_probe(name: str, c: dict) -> None:
    lib = c["library_ms"]
    log(f"q8_probe {name} plan: P={c['rows']} D={c['width']} staging {c['staging']} split "
        f"{c['split']} grid {c['grid']}: onedot {c['ms']:.4f} ms, "
        f"{100 * c['bound_ms'] / c['ms']:.1f}% of the {c['bound_ms']:.4f} ms bound, plain "
        f"{c['plain_ms']:.4f} ms, torch._int_mm "
        + (f"{lib:.4f} ms" if lib is not None else "refused the shapes"))


def phase_variant_check(dev) -> dict:
    """K4, K5, K6 and the probe against their plain versions (run in
    chunks of rows) at the tool geometry, a ragged P and the VidOR layout:
    K4, K6 and the probe equal bit for bit, K4 equal to K1 and K6 to K1
    transposed on the same rows, K5 within its bound; kernel and plain
    timed at each; then the probe alone at PROBE_CASES."""
    from tspn_tpu_torch.data.layout import FeatureLayout
    from tspn_tpu_torch.ops import pairwise as pw

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    before = dict(pw.LAUNCHES)
    report = {"q8i8": {}, "q8bf": {}, "q8t": {}, "q8_probe": {}}
    for name, objects, p in VARIANT_CASES:
        lo = FeatureLayout.for_objects(objects)
        t = variant_inputs(gen, lo, p, dev)
        d, r = lo.device_dim, NUM_PREDICATES
        flop = 2.0 * p * d * r
        k4 = lambda: pw.normalize_classify_q8i8(t["q"], t["hs"], t["qw_t"], t["sw"], t["b"], lo)
        k5 = lambda: pw.normalize_classify_q8(t["q"], t["hs"], t["w_bf16_t"], t["b"], lo)
        k6 = lambda: pw.normalize_classify_q8t(t["xt"], t["scales_t"], t["qw_t"], t["sw"],
                                               t["b"], lo)
        plain4 = lambda: in_chunks(p, 0, lambda s: pw.normalize_classify_q8i8_plain(
            t["q"][s], t["hs"][s], t["qw_t"], t["sw"], t["b"], lo))
        plain5 = lambda: in_chunks(p, 0, lambda s: pw.normalize_classify_q8_plain(
            t["q"][s], t["hs"][s], t["w_bf16_t"], t["b"], lo))
        plain6 = lambda: in_chunks(p, 1, lambda s: pw.normalize_classify_q8t_plain(
            t["xt"][:, s], t["scales_t"][:, s], t["qw_t"], t["sw"], t["b"], lo))
        k1 = pw.normalize_classify_q8s(t["q"], t["scales"], t["qw_t"], t["sw"], t["b"], lo)
        outs = {"q8i8": (k4(), plain4()), "q8bf": (k5(), plain5()), "q8t": (k6(), plain6())}
        torch.cuda.synchronize()
        for key, (out, ref) in outs.items():
            shape = (r, p) if key == "q8t" else (p, r)
            if out.shape != shape or not torch.isfinite(out).all():
                raise AssertionError(f"{key} {name}: bad output {tuple(out.shape)}")
        err = {k: float((o - f).abs().max()) for k, (o, f) in outs.items()}
        for key in ("q8i8", "q8t"):
            if not torch.equal(*outs[key]):
                raise AssertionError(f"{key} {name}: kernel != plain, max |err| {err[key]}")
        if not torch.equal(outs["q8i8"][0], k1):
            raise AssertionError(f"q8i8 {name}: K4 != K1 fed the same block scales")
        if not torch.equal(outs["q8t"][0], k1.T):
            raise AssertionError(f"q8t {name}: K6 != K1 transposed")
        worst5 = k5_worst_over_bound(t, *outs["q8bf"], lo)
        if worst5 > 1.0:
            raise AssertionError(f"q8bf {name}: |K5 - plain| exceeds the bound "
                                 f"(max err {err['q8bf']}, worst err/bound {worst5})")
        del outs, k1
        timed = {
            "q8i8": (k4, plain4, (t["q"], t["hs"], t["qw_t"], t["sw"], t["b"]), "int8"),
            "q8bf": (k5, plain5, (t["q"], t["hs"], t["w_bf16_t"], t["b"]), "bf16"),
            "q8t": (k6, plain6, (t["xt"], t["scales_t"], t["qw_t"], t["sw"], t["b"]), "int8"),
        }
        for key, (kern, plain, operands, kind) in timed.items():
            out = kern()
            report[key][name] = {
                "rows": p, "width": d, "cols": r, "max_abs_err": err[key],
                "ms": cuda_median_ms(kern), "plain_ms": cuda_median_ms(plain, iters=3),
                **bound(operands, out, flop, kind)}
            if key == "q8bf":
                report[key][name]["worst_err_over_bound"] = worst5
            del out

        report["q8_probe"][name] = probe_entry(t["xt"], t["w_probe"], dev)
        del t
        torch.cuda.empty_cache()
        for key in report:
            c = report[key][name]
            log(f"{key} {name}: P={c['rows']} D={c['width']} R={c['cols']} "
                f"max|err| {c['max_abs_err']:.3e}"
                + (f" (worst err/bound {c['worst_err_over_bound']:.3f})" if key == "q8bf"
                   else " equal=True")
                + f" kernel {c['ms']:.4f} ms plain {c['plain_ms']:.4f} ms bound "
                f"{c['bound_ms']:.4f} ms ({c['bound_by']})"
                + (f" library {c['library_ms']}" if key == "q8_probe" else ""))
        log_probe(name, report["q8_probe"][name])
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    for name, p, d in PROBE_CASES:
        x = torch.randint(-128, 128, (d, p), generator=gen, device=dev, dtype=torch.int8)
        w = torch.randint(-128, 128, (PROBE_ROWS, d), generator=gen, device=dev, dtype=torch.int8)
        report["q8_probe"][name] = probe_entry(x, w, dev)
        log_probe(name, report["q8_probe"][name])
        del x, w
    report["check_launches"] = {k: pw.LAUNCHES[k] - before[k] for k in pw.LAUNCHES}
    log(f"variant checks: launches {report['check_launches']}; torch._int_mm "
        + json.dumps({k: v for k, v in report["q8_probe"]["tool"].items()
                      if k.startswith("library")}))
    return report


def phase_tool(dev) -> dict:
    """The ported tools/bench_pair_kernels.py at its default 96 segments;
    every leg launches its kernel once per timed call."""
    from tspn_tpu_torch.tools import bench_pair_kernels as bench

    result = bench.main(["--segments", str(NUM_SEGMENTS), "--device", str(dev)])
    if len(result["legs"]) != 5 or result["pairs"] != NUM_SEGMENTS * 992:
        raise AssertionError(f"bench_pair_kernels: legs {list(result['legs'])}")
    return result


def rel_inputs(gen, p: int, dev) -> dict:
    """Operands of Kr, Kn and Ks4: int8 rows in [-128, 127] and int4 rows
    in [-8, 7] (the last 50 rows and every 13th row all zero), the int4
    rows packed, a (P, 16) sidecar and its (P, 128) padding, int8 weights
    (R 132) K-major, split into even and odd columns and wrapped to int4
    and packed, and f32 sw and b."""
    from tspn_tpu_torch.ops import pairwise as pw
    from tspn_tpu_torch.ops import rel

    d, r = pw.rel_geom().device_dim, NUM_PREDICATES
    x = torch.randint(-128, 128, (p, d), generator=gen, device=dev, dtype=torch.int8)
    x4 = torch.randint(-8, 8, (p, d), generator=gen, device=dev, dtype=torch.int8)
    for t in (x, x4):
        t[-50:] = 0
        t[::13] = 0
    s16 = torch.rand((p, 16), generator=gen, device=dev) / 64
    s128 = torch.zeros((p, 128), device=dev)
    s128[:, :16] = s16
    w_t = torch.randint(-127, 128, (r, d), generator=gen, device=dev, dtype=torch.int8)
    w_even, w_odd = rel.split_even_odd(w_t)
    w4 = rel.wrap_int4(w_t)
    return {"x": x, "x4": x4, "xp": rel.pack_int4(x4), "s16": s16, "s128": s128, "w_t": w_t,
            "w_even": w_even, "w_odd": w_odd, "w4": w4, "w4p": rel.pack_int4(w4),
            "sw": torch.rand((r,), generator=gen, device=dev) / 127,
            "b": torch.randn((r,), generator=gen, device=dev)}


def exact_product(a, b_t, p: int):
    """a @ b_t.T as int64, summed in float64 (exact) a chunk of rows at a time."""
    return in_chunks(p, 0, lambda s: (a[s].double() @ b_t.double().T).long())


def phase_rel_check(dev) -> dict:
    """Kr, Kn and Ks4 against their plain versions at the tools' geometry,
    a ragged P and 333 rows: the int32 results equal the int64 products,
    Kr f32 its plain version, Kr side K1's plain version in every
    schedule; at the tools' geometry kernel, plain, K1 and torch._int_mm
    timed, with their bounds."""
    from tspn_tpu_torch.ops import pairwise as pw
    from tspn_tpu_torch.ops import rel

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    geom = pw.rel_geom()
    before = dict(rel.LAUNCHES)
    report = {"rel_s8": {}, "rel_s4x8": {}, "rel_s4x4": {}}
    for name, p in REL_CASES:
        t = rel_inputs(gen, p, dev)
        x, w_t, s16, sw, b = t["x"], t["w_t"], t["s16"], t["sw"], t["b"]
        ops = 2.0 * p * x.shape[1] * NUM_PREDICATES
        kr = lambda: rel.rel_s8(x, w_t)
        kn = lambda: rel.rel_s4x8(t["xp"], t["w_even"], t["w_odd"])
        ks4 = lambda: rel.rel_s4x4(t["xp"], t["w4p"])
        plain = {
            "rel_s8": lambda: in_chunks(p, 0, lambda s: rel.rel_s8_plain(x[s], w_t)),
            "rel_s4x8": lambda: in_chunks(p, 0, lambda s: rel.rel_s4x8_plain(
                t["xp"][s], t["w_even"], t["w_odd"])),
            "rel_s4x4": lambda: in_chunks(p, 0, lambda s: rel.rel_s4x4_plain(
                t["xp"][s], t["w4p"])),
        }
        wants = {"rel_s8": exact_product(x, w_t, p), "rel_s4x8": exact_product(t["x4"], w_t, p),
                 "rel_s4x4": exact_product(t["x4"], t["w4"], p)}
        for key, fn in (("rel_s8", kr), ("rel_s4x8", kn), ("rel_s4x4", ks4)):
            out = fn()
            torch.cuda.synchronize()
            if out.shape != (p, NUM_PREDICATES) or out.dtype != torch.int32:
                raise AssertionError(f"{key} {name}: bad output {out.dtype} {tuple(out.shape)}")
            err = int((out.long() - wants[key]).abs().max())
            if not torch.equal(out.long(), wants[key]):
                raise AssertionError(f"{key} {name}: kernel != int64 product, max |err| {err}")
            report[key][name] = {"rows": p, "width": x.shape[1], "cols": NUM_PREDICATES,
                                 "max_abs_err": err}
        del wants
        ref_f32 = in_chunks(p, 0, lambda s: rel.rel_s8_plain(x[s], w_t, None, sw, b,
                                                             epilogue="f32"))
        out = rel.rel_s8(x, w_t, None, sw, b, epilogue="f32")
        if not torch.equal(out, ref_f32):
            raise AssertionError(f"rel_s8 f32 {name}: kernel != plain, max |err| "
                                 f"{(out - ref_f32).abs().max().item()}")
        del ref_f32
        ref_side = in_chunks(p, 0, lambda s: pw.normalize_classify_q8s_plain(
            x[s], s16[s], w_t, sw, b, geom))
        sides = {}
        for label, stages, schedule, ks, width in REL_SCHEDULES:
            s = s16 if width == 16 else t["s128"]
            sides[label] = lambda s=s, k=(stages, schedule, ks): rel.rel_s8(
                x, w_t, s, sw, b, epilogue="side", stages=k[0], schedule=k[1], ks=k[2])
            out = sides[label]()
            torch.cuda.synchronize()
            if not torch.equal(out, ref_side):
                raise AssertionError(f"rel_s8 side {label} {name}: kernel != K1's plain "
                                     f"version, max |err| {(out - ref_side).abs().max().item()}")
        del out, ref_side
        report["rel_s8"][name]["side_schedules_equal_k1_plain"] = [lbl for lbl, *_ in REL_SCHEDULES]
        if name == "tool":
            q8s_args = (x, s16, w_t, sw, b, geom)
            timed = {"rel_s8": (kr, (x, w_t), ops), "rel_s4x8": (kn, (t["xp"], t["w_even"],
                                                                      t["w_odd"]), 0.0),
                     "rel_s4x4": (ks4, (t["xp"], t["w4p"]), 0.0)}
            for key, (fn, operands, leg_ops) in timed.items():
                out = fn()
                report[key][name].update({
                    "ms": cuda_median_ms(fn), "plain_ms": cuda_median_ms(plain[key], iters=3),
                    **bound(operands, out, leg_ops, "int8"), "library_ms": None})
            side_out = sides["grid3"]()
            if not torch.equal(side_out, pw.normalize_classify_q8s(*q8s_args)):
                raise AssertionError("rel_s8 side tool: Kr != K1 on the same rows")
            report["rel_s8"][name].update({
                "f32_ms": cuda_median_ms(lambda: rel.rel_s8(x, w_t, None, sw, b,
                                                            epilogue="f32")),
                "side_ms": {label: cuda_median_ms(fn) for label, fn in sides.items()},
                "side_plain_ms": cuda_median_ms(lambda: in_chunks(
                    p, 0, lambda s: rel.rel_s8_plain(x[s], w_t, s16[s], sw, b,
                                                     epilogue="side")), iters=3),
                "side_bound": bound((x, s16[:, :1], w_t, sw, b), side_out, ops, "int8"),
                "k1_q8s_ms": cuda_median_ms(lambda: pw.normalize_classify_q8s(*q8s_args)),
            })
            # one PyTorch call of Kr's int32 product, never used by the port:
            # W padded to 136 columns (torch._int_mm takes N % 8 == 0)
            w_pad = torch.zeros((x.shape[1], 136), dtype=torch.int8, device=dev)
            w_pad[:, :NUM_PREDICATES] = w_t.T
            lib = torch._int_mm(x, w_pad)[:, :NUM_PREDICATES]
            report["rel_s8"][name]["library_equal"] = torch.equal(lib, kr())
            report["rel_s8"][name]["library_ms"] = cuda_median_ms(lambda: torch._int_mm(x, w_pad))
            del out, side_out, lib, w_pad
        del t
        torch.cuda.empty_cache()
        for key in report:
            c = report[key][name]
            log(f"{key} {name}: P={c['rows']} D={c['width']} R={c['cols']} equal=True"
                + (f" kernel {c['ms']:.4f} ms plain {c['plain_ms']:.4f} ms bound "
                   f"{c['bound_ms']:.4f} ms ({c['bound_by']}) library {c['library_ms']}"
                   if "ms" in c else ""))
    tool = report["rel_s8"]["tool"]
    log(f"rel_s8 tool: f32 {tool['f32_ms']:.4f} ms; side by schedule {json.dumps(tool['side_ms'])}"
        f" (plain {tool['side_plain_ms']:.4f} ms, bound {tool['side_bound']['bound_ms']:.4f} ms);"
        f" K1 {tool['k1_q8s_ms']:.4f} ms; torch._int_mm {tool['library_ms']:.4f} ms,"
        f" equal {tool['library_equal']}")
    report["check_launches"] = {k: rel.LAUNCHES[k] - before[k] for k in rel.LAUNCHES}
    log(f"rel checks: launches {report['check_launches']}")
    return report


def phase_rel_tools(dev) -> dict:
    """The four ported rel tools at their defaults; each leg checked once
    and timed."""
    from tspn_tpu_torch.tools import (bench_rel_int4, bench_rel_pipeline, bench_rel_probe,
                                      bench_rel_steps)

    d = ["--device", str(dev)]
    results = {"steps": bench_rel_steps.main(d), "pipeline": bench_rel_pipeline.main(d),
               "probe": bench_rel_probe.main(d)}
    legs = {"steps": 5, "pipeline": 7, "probe": 6}
    for tool, n in legs.items():
        if len(results[tool]["legs"]) != n or results[tool]["pairs"] != NUM_SEGMENTS * 992:
            raise AssertionError(f"bench_rel_{tool}: legs {list(results[tool]['legs'])}")
    int4 = bench_rel_int4.main(d)
    if not all(int4[f"{leg}_exact"] for leg in ("i8xi8", "i4xi8", "i4xi4")):
        raise AssertionError(f"bench_rel_int4: {int4}")
    results["int4"] = int4
    return results


def rel_tool_launches(results: dict) -> dict:
    """Launches the rel tools must make: one check call and one call per
    timed call (WARMUP + ITERS * REPS) of each kernel leg."""
    per_leg = 1 + WARMUP + ITERS * REPS
    want = {}
    for tool in ("steps", "pipeline", "probe"):
        for leg in results[tool]["legs"].values():
            if leg["kernel"]:
                want[leg["kernel"]] = want.get(leg["kernel"], 0) + per_leg
    for kernel in ("rel_s8", "rel_s4x8", "rel_s4x4"):  # i8xi8, i4xi8, i4xi4
        want[kernel] = want.get(kernel, 0) + per_leg
    return want


def bf16_terms(x, w_t, b, lo):
    """(T, M) in float64 for K3 bf16's bound: the summed |terms| of each
    output plus |b|, and its largest |term|."""
    p = x.shape[0]
    hp, nb, blk = lo.dev_head_pad, lo.num_bow_blocks, lo.dev_block
    bow = x[:, hp:].float().reshape(p, nb, blk)
    s = bow.abs().sum(-1, keepdim=True)
    bow_n = (bow / torch.where(s > 0, s, torch.ones_like(s))).to(torch.bfloat16)
    xn = torch.cat([x[:, :hp], bow_n.reshape(p, -1)], 1).double().abs()
    del bow
    wa = w_t.double().abs().T
    m = torch.stack([(xn * wa[:, j]).amax(1) for j in range(wa.shape[1])], 1)
    return xn @ wa + b.double().abs(), m


def phase_k3_bf16_check(dev) -> dict:
    """K3's bf16 half against its plain version at K3's three geometries
    (the f32 phase's rows rounded to bf16): |kernel - plain| <= 1e-5 * T +
    2**-8 * M per element, at most 0.1% of the outputs needing the second
    term; kernel and plain timed."""
    from tspn_tpu_torch.data.layout import DEFAULT_LAYOUT as lo
    from tspn_tpu_torch.ops import pairwise as pw

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    w_t = pw.weights_bf16_t(
        torch.randn((lo.device_dim, NUM_PREDICATES), generator=gen, device=dev) * 0.01)
    b = torch.randn((NUM_PREDICATES,), generator=gen, device=dev)
    report = {}
    for name, p, zero_rows in FUSED_CASES:
        x = raw_device_rows(p, zero_rows, gen, dev).to(torch.bfloat16)
        out = pw.normalize_classify_fused_bf16(x, w_t, b, lo)
        ref = pw.normalize_classify_fused_bf16_plain(x, w_t, b, lo)
        torch.cuda.synchronize()
        if out.shape != (p, NUM_PREDICATES) or not torch.isfinite(out).all():
            raise AssertionError(f"fused_classify_bf16 {name}: bad output {tuple(out.shape)}")
        t, m = bf16_terms(x, w_t, b, lo)
        err = (out.double() - ref.double()).abs()
        worst = float((err / (1e-5 * t + 2.0 ** -8 * m)).max())
        second = int((err > 1e-5 * t).sum())
        max_err = float(err.max())
        del t, m, err
        if worst > 1.0 or second > 1e-3 * out.numel():
            raise AssertionError(
                f"fused_classify_bf16 {name}: worst err/bound {worst}, {second} of "
                f"{out.numel()} outputs need the 2**-8 M term (max err {max_err})")
        ms = cuda_median_ms(lambda: pw.normalize_classify_fused_bf16(x, w_t, b, lo))
        plain_ms = cuda_median_ms(lambda: pw.normalize_classify_fused_bf16_plain(x, w_t, b, lo))
        flop = 2.0 * p * lo.device_dim * NUM_PREDICATES
        report[name] = {"rows": p, "width": lo.device_dim, "cols": NUM_PREDICATES,
                        "max_abs_err": max_err, "worst_err_over_bound": worst,
                        "outputs_needing_second_term": second, "outputs": out.numel(),
                        "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                        **bound((x, w_t, b), out, flop, "bf16")}
        log(f"fused_classify_bf16 {name}: P={p} D={lo.device_dim} R={NUM_PREDICATES} "
            f"max|err| {max_err:.3e} (worst err/bound {worst:.3f}; {second} of "
            f"{out.numel()} outputs need the 2**-8 M term) kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms bound {report[name]['bound_ms']:.4f} ms "
            f"({report[name]['bound_by']})")
        del x, out, ref
    return report


def roi_edge_inputs(b, r, h, w, c, dev, seed=0):
    """(b, h, w, c) f32 maps of randn and (b, r, 4) boxes, the first of
    image 0 across the border."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    feats = torch.randn(b, h, w, c, generator=gen)
    size = torch.tensor([w, h], dtype=torch.float32)
    lo = torch.rand(b, r, 2, generator=gen) * (size - 2)
    wh = 1 + torch.rand(b, r, 2, generator=gen) * (size / 2 - 1)
    boxes = torch.cat([lo, lo + wh], dim=-1)
    boxes[0, 0] = torch.tensor([-1.5, -1.0, 3.0, h + 1.0])
    return feats.to(dev), boxes.to(dev)


def roi_within_plain(name, kernel, plain, feats, boxes, terms) -> tuple:
    """One check of a T-roi kernel against its plain version within
    1e-5 * T + 1e-6 (plus one bf16 ulp for a bf16 output) -> (the
    kernel's output, the check's entry)."""
    from tspn_tpu_torch.tools import roi_common as rc

    out = kernel(feats, boxes)
    ref = plain(feats, boxes)
    torch.cuda.synchronize()
    worst = rc.over_bound(out, ref, terms, 1e-5, ulp=out.dtype == torch.bfloat16)
    max_err = float((out.double() - ref.double()).abs().max())
    if not worst <= 1.0 or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: worst err/bound {worst}, max err {max_err}")
    return out, {"shape": list(out.shape), "max_abs_err": max_err, "worst_err_over_bound": worst}


def phase_roi_check(dev) -> dict:
    """T-roi 1-3 against their plain versions at the tools' default
    geometry in f32 and bf16, within 1e-5 * T + 1e-6 (plus one bf16 ulp
    for a bf16 output); kernel, plain and, for selector and constg,
    torch.matmul with G materialized, timed, each beside its bound. Then
    all three at the tiling edges (ROI_EDGE_CASES; the fused kernel where
    W <= 112, and it must refuse the rest) and roi_sep_fused at
    ROI_SEP_EDGE_CASES, checked."""
    from tspn_tpu_torch.ops import roi_probes as rp
    from tspn_tpu_torch.tools import roi_common as rc

    a = ROI_TOOL
    feats32, boxes = rc.inputs(a, dev)
    terms = rc.sum_terms(feats32, boxes)
    const_terms = rp.roi_constg_plain(feats32.abs(), boxes).abs()
    s1, s2 = rc.sep_ops(a.batch, a.rois, a.hw, a.hw, a.channels)
    g_ops = rc.gemm_ops(a.batch, a.rois, a.hw, a.hw, a.channels)
    report = {"roi_sep_fused": {}, "roi_selector": {}, "roi_constg": {}}
    f2 = feats32.reshape(a.batch, a.hw * a.hw, a.channels)
    for dtype in ("f32", "bf16"):
        feats = feats32.to(rc.DTYPES[dtype])
        kd = rc.kind(feats.dtype)
        cases = (("roi_sep_fused", rp.roi_sep_fused, rp.roi_sep_fused_plain, terms,
                  rc.ops_by_kind((kd, s1), ("f32", s2))),
                 ("roi_selector", rp.roi_selector, rp.roi_selector_plain, terms, {kd: g_ops}),
                 ("roi_constg", rp.roi_constg, rp.roi_constg_plain, const_terms, {kd: g_ops}))
        for name, kernel, plain, t, ops in cases:
            out, entry = roi_within_plain(f"{name} {dtype}", kernel, plain, feats, boxes, t)
            entry.update(ms=cuda_median_ms(lambda: kernel(feats, boxes)),
                         plain_ms=cuda_median_ms(lambda: plain(feats, boxes), iters=3),
                         library_ms=None, **bound((feats, boxes), out, ops))
            del out
            if name != "roi_sep_fused":
                g = rc.materialized_g(boxes, a.hw, a.hw, feats.dtype, name == "roi_constg")
                fd = f2.to(feats.dtype)
                entry["library_ms"] = cuda_median_ms(lambda: torch.matmul(g, fd))
                del g, fd
            report[name][dtype] = entry
            log(f"{name} {dtype}: {tuple(entry['shape'])} max|err| {entry['max_abs_err']:.3e} "
                f"(worst err/bound {entry['worst_err_over_bound']:.3f}) kernel "
                f"{entry['ms']:.4f} ms plain {entry['plain_ms']:.4f} ms bound "
                f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}, "
                f"{100 * entry['bound_ms'] / entry['ms']:.1f}% reached) library "
                f"{entry['library_ms']}")
        del feats
        torch.cuda.empty_cache()
    for case, b, r, h, w, c in ROI_EDGE_CASES + ROI_SEP_EDGE_CASES:
        e32, eboxes = roi_edge_inputs(b, r, h, w, c, dev)
        eterms = rc.sum_terms(e32, eboxes)
        econst = rp.roi_constg_plain(e32.abs(), eboxes).abs()
        for dtype in ("f32", "bf16"):
            feats = e32.to(rc.DTYPES[dtype])
            cases = [("roi_sep_fused", rp.roi_sep_fused, rp.roi_sep_fused_plain, eterms)]
            if w > 112:  # past the fused kernel's contract: it must refuse
                try:
                    rp.roi_sep_fused(feats, eboxes)
                except ValueError:
                    cases = []
                else:
                    raise AssertionError(f"roi_sep_fused took a {h} x {w} map")
            if c % 128 == 0:
                cases += [("roi_selector", rp.roi_selector, rp.roi_selector_plain, eterms),
                          ("roi_constg", rp.roi_constg, rp.roi_constg_plain, econst)]
            for name, kernel, plain, t in cases:
                _, entry = roi_within_plain(f"{name} {dtype} {case}", kernel, plain, feats,
                                            eboxes, t)
                report[name][f"{case}_{dtype}"] = entry
                log(f"{name} {dtype} {case}: {b} x {r} RoIs on {h}x{w}x{c}: max|err| "
                    f"{entry['max_abs_err']:.3e} (worst err/bound "
                    f"{entry['worst_err_over_bound']:.3f})")
        del e32, eterms, econst
    return report


def phase_roi_tools(dev) -> dict:
    """The two ported RoIAlign probe tools at their defaults, in f32 and
    bf16; each holds its kernel legs to their plain versions and every leg
    to roi_align_plain before timing it."""
    from tspn_tpu_torch.tools import bench_roialign_fused, bench_roialign_variants

    results = {}
    for tool, mod in (("fused", bench_roialign_fused), ("variants", bench_roialign_variants)):
        for dtype in ("f32", "bf16"):
            results[f"{tool}_{dtype}"] = mod.main(["--dtype", dtype, "--device", str(dev)])
    if any(results[f"variants_{d}"]["grid_ms"] is None for d in ("f32", "bf16")):
        raise AssertionError("bench_roialign_variants: the grid leg must run in f32 and bf16")
    return results


def k7_ops(s: int, out_numel: int) -> float:
    """K7's f32 operations (forward, or the backward's transpose): per
    output element s*s samples of 6 mul + 3 add, s*s sums, 1 divide."""
    return (10.0 * s * s + 1.0) * out_numel


def phase_k7_bf16_check(dev) -> dict:
    """K7's bf16 half vs roi_align_plain on the same bf16 maps (in chunks),
    bit for bit, at phase 14's geometries; both timed."""
    from tspn_tpu_torch.ops import roi_align as ra

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    report = {}
    for name, n, h, w, c, r, out, s, kind in K7_CASES:
        feats, boxes, idx = k7_inputs(gen, n, h, w, c, r, kind, dev)
        feats = feats.bfloat16()
        got = ra.roi_align(feats, boxes, idx, out, s)
        ref = roi_align_plain_chunked(feats, boxes, idx, out, s)
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16 or got.shape != (r, out, out, c):
            raise AssertionError(f"roi_align bf16 {name}: bad output {got.dtype} "
                                 f"{tuple(got.shape)}")
        max_err = float((got.float() - ref.float()).abs().max())
        if not torch.equal(got, ref):
            raise AssertionError(f"roi_align bf16 {name}: K7 differs from plain "
                                 f"(max err {max_err})")
        del ref
        ms = cuda_median_ms(lambda: ra.roi_align(feats, boxes, idx, out, s))
        plain_ms = cuda_median_ms(
            lambda: roi_align_plain_chunked(feats, boxes, idx, out, s), iters=3)
        report[name] = {"images": n, "map": [h, w, c], "rois": r, "out": out,
                        "sampling_ratio": s, "max_abs_err": max_err, "ms": ms,
                        "plain_ms": plain_ms,
                        **bound((feats, boxes, idx), got, k7_ops(s, got.numel()), "f32")}
        log(f"roi_align bf16 {name}: {n} x {h}x{w}x{c}, {r} RoIs, out {out}, s {s}, "
            f"{ra._vec(c, feats, widest=8)} channels a thread: equal "
            f"to plain; kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
            f"{report[name]['bound_ms']:.4f} ms ({report[name]['bound_by']}, "
            f"{report[name]['bytes'] / 1e9:.3f} GB)")
        del feats, boxes, idx, got
    return report


def phase_k7_backward_check(dev) -> dict:
    """K7's backward vs the plain backward (autograd of roi_align_plain in
    chunks) in f32 and bf16 within 1e-5 * T + 1e-6 (+ one bf16 ulp);
    timed at the training geometry."""
    from tspn_tpu_torch.ops import roi_align as ra
    from tspn_tpu_torch.tools.roi_common import bf16_ulp

    report = {"f32": {}, "bf16": {}}
    for dtype_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        gen = torch.Generator(device=dev).manual_seed(SEED + 4)
        for name, n, h, w, c, r, out, s, kind in K7_BACKWARD_CASES:
            feats, boxes, idx = k7_inputs(gen, n, h, w, c, r, kind, dev)
            shape = feats.shape
            del feats
            dout = (torch.rand((r, out, out, c), generator=gen, device=dev) * 2 - 1).to(dtype)

            def kernel():
                return ra.roi_align_backward(dout, boxes, idx, shape, dtype, out, s)

            def plain(d=dout, out_dtype=dtype):
                return ra.roi_align_backward_plain(d, boxes, idx, shape, out_dtype, out, s,
                                                   chunk=PLAIN_CHUNK)

            got = kernel()
            ref = plain().double()
            terms = plain(dout.abs(), torch.float32).double()  # T, in f32
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != shape or not torch.isfinite(got).all():
                raise AssertionError(f"roi_align backward {dtype_name} {name}: bad output")
            tol = 1e-5 * terms + 1e-6
            if dtype == torch.bfloat16:
                tol = tol + bf16_ulp(ref)
            err = (got.double() - ref).abs()
            worst = float((err / tol).max())
            max_err = float(err.max())
            del err, tol, terms
            if worst > 1.0:
                raise AssertionError(f"roi_align backward {dtype_name} {name}: |kernel - "
                                     f"plain| exceeds the bound (max err {max_err}, worst "
                                     f"err/bound {worst})")
            entry = {"images": n, "map": [h, w, c], "rois": r, "out": out,
                     "sampling_ratio": s, "max_abs_err": max_err,
                     "worst_err_over_bound": worst,
                     **bound((dout, boxes, idx), got, k7_ops(s, dout.numel()), "f32")}
            if name == "train":
                entry["ms"] = cuda_median_ms(kernel)
                entry["plain_ms"] = cuda_median_ms(plain, iters=3)
            report[dtype_name][name] = entry
            log(f"roi_align backward {dtype_name} {name}: {n} x {h}x{w}x{c}, {r} RoIs, out "
                f"{out}, s {s}: max|err| {max_err:.3e} (worst err/bound {worst:.3f})"
                + (f" kernel {entry['ms']:.4f} ms plain {entry['plain_ms']:.4f} ms"
                   if "ms" in entry else "")
                + f" bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}, "
                f"{entry['bytes'] / 1e9:.3f} GB)")
            del dout, boxes, idx, got, ref
    torch.cuda.empty_cache()
    return report


def detector_train_records(n: int, seed: int) -> list:
    """n records of (480, 640, 3) uint8 noise with 1-8 flat boxes of random
    classes (of 35) drawn on it, as COCO-format dicts with in-memory
    images (no image files, no PIL)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    h, w = DET_TRAIN_HW
    records = []
    for i in range(n):
        img = (rng.rand(h, w, 3) * 64).astype(np.uint8)
        anns = []
        for _ in range(rng.randint(1, 9)):
            bw, bh = rng.randint(24, w // 2), rng.randint(24, h // 2)
            x0, y0 = rng.randint(0, w - bw), rng.randint(0, h - bh)
            img[y0 : y0 + bh, x0 : x0 + bw] = rng.randint(64, 256, 3)
            anns.append({"bbox": [float(x0), float(y0), float(x0 + bw), float(y0 + bh)],
                         "category_id": int(rng.randint(0, 35)), "bbox_mode": "XYXY_ABS"})
        records.append({"image": img, "image_id": i, "height": h, "width": w,
                        "annotations": anns})
    return records


def phase_detector_train(dev) -> dict:
    """Detector training at full width through train_detector, K7 and the
    plain RoIAlign in turns, in f32 and bf16; a traced step per type;
    the first kernel run's checkpoint reloads into a detector that
    detects."""
    import logging
    import tempfile

    from tspn_tpu_torch.detection import train as dt
    from tspn_tpu_torch.detection.inputs import DetectorTrainConfig, make_batch
    from tspn_tpu_torch.detection.rcnn import DetectionConfig
    from tspn_tpu_torch.runtime.checkpoint import load_detector_checkpoint

    t0 = time.perf_counter()
    records = detector_train_records(DET_TRAIN_RECORDS, SEED)
    log(f"detector train: {DET_TRAIN_RECORDS} records of {DET_TRAIN_HW} made in "
        f"{time.perf_counter() - t0:.1f} s")
    quiet = logging.getLogger("chip_smoke.detector_train")
    quiet.setLevel(logging.WARNING)
    det_cfg = DetectionConfig()
    workdir = tempfile.mkdtemp(prefix="detector_train_")
    ckpt = f"{workdir}/detector.pt"
    result = {}
    for dtype_name, bf16, rtol in (("f32", False, 1e-4), ("bf16", True, 1e-2)):
        cfg = DetectorTrainConfig(max_iter=DET_TRAIN_STEPS, log_every=1, mixed_precision=bf16)
        runs = {"plain": [], "kernel": []}
        first, peak, kept_model = {}, {}, None
        for variant in ("plain", "kernel", "kernel", "plain"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            save = ckpt if (variant == "kernel" and not bf16 and not runs["kernel"]) else None
            model, hist = dt.train_detector(
                records, det_cfg, cfg, seed=SEED, logger=quiet, device=dev,
                checkpoint_path=save,
                roi_pool=None if variant == "kernel" else roi_align_plain_chunked)
            torch.cuda.synchronize()
            losses = hist["losses"]
            if len(losses) != DET_TRAIN_STEPS or not all(
                    math.isfinite(v) for step in losses for v in step.values()):
                raise AssertionError(f"detector train {dtype_name} {variant}: bad losses "
                                     f"{losses}")
            runs[variant].append(1.0 / statistics.median(hist["step_seconds"][1:]))
            first.setdefault(variant, losses[0])
            peak[variant] = max(peak.get(variant, 0.0),
                                torch.cuda.max_memory_allocated(dev) / 1e9)
            if variant == "kernel":
                kept_model = model
            del model
        diff = {k: abs(first["kernel"][k] - first["plain"][k]) / abs(first["plain"][k])
                for k in first["plain"]}
        if max(diff.values()) > rtol:
            raise AssertionError(f"detector train {dtype_name}: step-1 losses kernel "
                                 f"{first['kernel']} plain {first['plain']} beyond rtol {rtol}")
        # one traced step of the kernel-run model (a warm-up step first)
        batch = dt.batch_to_device(make_batch(records[: cfg.ims_per_batch], cfg), dev)
        optimizer, scheduler = dt.build_detector_optimizer(kept_model.parameters(), cfg)
        dt.detector_train_step(kept_model, optimizer, scheduler, batch)
        prof = traced_run(f"detector train {dtype_name}",
                          lambda: dt.detector_train_step(kept_model, optimizer, scheduler,
                                                         batch),
                          watch=("roi_align_kernel", "roi_align_backward_kernel"))
        del kept_model, optimizer, scheduler, batch
        fwd_ms = prof["watched_device_ms"]["roi_align_kernel"]
        bwd_ms = prof["watched_device_ms"]["roi_align_backward_kernel"]
        result[dtype_name] = {
            "steps": DET_TRAIN_STEPS, "ims_per_batch": cfg.ims_per_batch,
            "image_size": cfg.image_size, "first_losses": first,
            "step1_rel_diff": diff, "last_losses": losses[-1],
            "steps_per_s": statistics.median(runs["kernel"]),
            "plain_steps_per_s": statistics.median(runs["plain"]), "runs": runs,
            "peak_memory_gb": peak,
            "k7_forward_device_ms": fwd_ms, "k7_backward_device_ms": bwd_ms,
            "k7_forward_share": fwd_ms / prof["device_ms"],
            "k7_backward_share": bwd_ms / prof["device_ms"],
            "profile": prof}
        log(f"detector train {dtype_name}: {DET_TRAIN_STEPS} steps a run, step-1 losses "
            f"{first['kernel']} (max rel diff to plain {max(diff.values()):.3e}); steps/s "
            f"kernel {runs['kernel']} plain {runs['plain']}; peak {peak} GB; K7 forward "
            f"{fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms of {prof['device_ms']:.1f} ms device "
            f"time in a traced step")
        log(f"detector train {dtype_name} profile: {json.dumps(prof)}")
        torch.cuda.empty_cache()

    # train_detector's own loop traced (f32, K7): its wait for each batch
    # from the producer thread is a tspn.input_wait span and input_wait_s
    loop_cfg = DetectorTrainConfig(max_iter=DET_TRAIN_TRACED_STEPS, log_every=1)
    trained = []
    prof = traced_run("detector train loop f32", lambda: trained.append(dt.train_detector(
        records, det_cfg, loop_cfg, seed=SEED, logger=quiet, device=dev)))
    waits = prof["spans"].get("tspn.input_wait", {})
    hist = trained[0][1]
    if waits.get("count") != DET_TRAIN_TRACED_STEPS or len(
            hist["input_wait_s"]) != DET_TRAIN_TRACED_STEPS:
        raise AssertionError(f"detector train loop: {waits} input-wait spans, "
                             f"input_wait_s {hist['input_wait_s']}, want "
                             f"{DET_TRAIN_TRACED_STEPS} of each")
    result["traced_loop"] = {"steps": DET_TRAIN_TRACED_STEPS,
                             "input_wait_s": hist["input_wait_s"],
                             "step_seconds": hist["step_seconds"], "profile": prof}
    log(f"detector train loop f32, traced: input_wait_s {hist['input_wait_s']} "
        f"(host clock), tspn.input_wait {waits}")
    del trained, hist
    torch.cuda.empty_cache()

    # the checkpoint reloads into a detector that detects
    model = seeded_detector(dev, state_dict=load_detector_checkpoint(ckpt))
    frames = synthetic_frames(DET_BATCH, SEED + 1)
    with torch.no_grad():
        dets = model.detect(torch.as_tensor(frames, device=dev))
    kept = check_detections({k: v.cpu() for k, v in dets.items()}, DET_BATCH,
                            model.cfg.num_classes)
    result["checkpoint"] = {"path_kind": "native torch.save", "kept_detections": kept}
    log(f"detector train: the checkpoint reloads and detects ({kept} kept over "
        f"{DET_BATCH} frames)")
    del model
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return result


def k7_levels_inputs(gen, n, canvas_hw, r, dev, c=256):
    """P2-P5 of n images on a canvas (channels-last, in [0, 1)), r RoIs in
    image coordinates with sides from 1 to 900 pixels (every level), some
    past the borders, one the whole canvas, one past its corner and one
    empty, spread at random over the images; -> maps, boxes, batch_idx and
    the RoIs' levels (detectron2's rule, on the device)."""
    from tspn_tpu_torch.detection.fpn import assign_levels

    h, w = canvas_hw
    maps = [torch.rand((n, h // s, w // s, c), generator=gen, device=dev) for s in (4, 8, 16, 32)]
    side = torch.exp(torch.rand((r, 2), generator=gen, device=dev) * math.log(900.0))
    lo = (torch.rand((r, 2), generator=gen, device=dev) * 1.1 - 0.1) * torch.tensor(
        [w, h], dtype=torch.float32, device=dev)
    boxes = torch.cat([lo, lo + side], 1)
    boxes[:3] = torch.tensor([[0.0, 0.0, w, h], [w - 3.0, h - 2.0, w + 40.0, h + 50.0],
                              [8.0, 8.0, 8.0, 8.0]], device=dev)
    idx = torch.randint(0, n, (r,), generator=gen, device=dev).to(torch.int32)
    return maps, boxes.contiguous(), idx, assign_levels(boxes)


def roi_align_levels_plain_chunked(maps, boxes, batch_idx, levels, scales,
                                   output_size=7, sampling_ratio=2):
    """roi_align_levels_plain over LEVELS_CHUNK RoIs at a time; the
    signature of FPNFasterRCNN.roi_pool."""
    from tspn_tpu_torch.ops import roi_align as ra

    return torch.cat([
        ra.roi_align_levels_plain(maps, boxes[k : k + LEVELS_CHUNK],
                                  batch_idx[k : k + LEVELS_CHUNK], levels[k : k + LEVELS_CHUNK],
                                  scales, output_size, sampling_ratio)
        for k in range(0, boxes.shape[0], LEVELS_CHUNK)
    ])


def phase_k7_levels_check(dev) -> dict:
    """K7's levels form against roi_align_levels_plain (in chunks) at the
    FPN cells' geometries: the forward bit for bit, the backward within
    1e-5 * T + 1e-6 (T the plain backward of |dOut|); timed beside their
    bound, which counts the output written once (and the backward's dOut
    read once) with the boxes, images and levels, not the maps: a RoI
    reads only the part of one map under its box."""
    from tspn_tpu_torch.ops import roi_align as ra

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    report = {"forward": {}, "backward": {}}
    for name, n, hw, r, timed in K7_LEVELS_CASES:
        maps, boxes, idx, levels = k7_levels_inputs(gen, n, hw, r, dev)

        def kernel():
            return ra.roi_align_levels(maps, boxes, idx, levels, FPN_SCALES, 7, 2)

        before = ra.LAUNCHES["roi_align_levels"]
        got = kernel()
        if ra.LAUNCHES["roi_align_levels"] != before + 1:
            raise AssertionError(f"roi_align_levels {name}: not one launch a call")
        ref = roi_align_levels_plain_chunked(maps, boxes, idx, levels, FPN_SCALES)
        torch.cuda.synchronize()
        max_err = float((got - ref).abs().max())
        if got.shape != (r, 7, 7, maps[0].shape[-1]) or not torch.equal(got, ref):
            raise AssertionError(f"roi_align_levels {name}: K7 differs from plain (max err "
                                 f"{max_err})")
        del ref
        per_level = torch.bincount(levels.long(), minlength=4).tolist()
        entry = {"images": n, "canvas": list(hw), "rois": r, "rois_a_level": per_level,
                 "max_abs_err": max_err,
                 **bound((boxes, idx, levels), got, k7_ops(2, got.numel()), "f32")}
        if timed:
            entry["ms"] = cuda_median_ms(kernel)
            entry["plain_ms"] = cuda_median_ms(
                lambda: roi_align_levels_plain_chunked(maps, boxes, idx, levels, FPN_SCALES),
                iters=1)
        report["forward"][name] = entry
        log(f"roi_align_levels {name}: {n} x P2-P5 of {hw[0]}x{hw[1]}, {r} RoIs "
            f"({per_level} a level): equal to plain"
            + (f"; kernel {entry['ms']:.4f} ms plain {entry['plain_ms']:.4f} ms"
               if timed else "")
            + f" bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}, "
            f"{entry['bytes'] / 1e9:.3f} GB)")
        del maps, boxes, idx, levels, got
    for name, n, hw, r, timed in K7_LEVELS_BACKWARD_CASES:
        maps, boxes, idx, levels = k7_levels_inputs(gen, n, hw, r, dev)
        dout = torch.rand((r, 7, 7, maps[0].shape[-1]), generator=gen, device=dev) * 2 - 1
        leaves = [m.requires_grad_(True) for m in maps]
        out = ra.roi_align_levels(leaves, boxes, idx, levels, FPN_SCALES, 7, 2)

        def kernel():
            return torch.autograd.grad(out, leaves, dout, retain_graph=True)

        def plain(cot):
            total = [torch.zeros_like(m) for m in maps]
            for k in range(0, r, 128):
                f = [m.detach().requires_grad_(True) for m in maps]
                part = ra.roi_align_levels_plain(f, boxes[k : k + 128], idx[k : k + 128],
                                                 levels[k : k + 128], FPN_SCALES, 7, 2)
                grads = torch.autograd.grad((part * cot[k : k + 128]).sum(), f,
                                            allow_unused=True)
                total = [t if g is None else t + g for t, g in zip(total, grads)]
            return total

        before = ra.LAUNCHES["roi_align_levels_backward"]
        got = kernel()
        if ra.LAUNCHES["roi_align_levels_backward"] != before + 1:
            raise AssertionError(f"roi_align_levels backward {name}: not one launch a call")
        worst, max_err = 0.0, 0.0
        for g, ref, terms in zip(got, plain(dout), plain(dout.abs())):
            err = (g.double() - ref.double()).abs()
            worst = max(worst, float((err / (1e-5 * terms.double() + 1e-6)).max()))
            max_err = max(max_err, float(err.max()))
            del err
        if worst > 1.0:
            raise AssertionError(f"roi_align_levels backward {name}: |kernel - plain| exceeds "
                                 f"the bound (max err {max_err}, worst err/bound {worst})")
        entry = {"images": n, "canvas": list(hw), "rois": r, "max_abs_err": max_err,
                 "worst_err_over_bound": worst,
                 **bound((dout, boxes, idx, levels), boxes.new_empty(0),
                         k7_ops(2, dout.numel()), "f32")}
        if timed:
            entry["ms"] = cuda_median_ms(kernel)
            entry["plain_ms"] = cuda_median_ms(lambda: plain(dout), iters=1)
        report["backward"][name] = entry
        log(f"roi_align_levels backward {name}: {n} x P2-P5 of {hw[0]}x{hw[1]}, {r} RoIs: "
            f"max|err| {max_err:.3e} (worst err/bound {worst:.3f})"
            + (f" kernel {entry['ms']:.4f} ms (the four dF maps zeroed with it) plain "
               f"{entry['plain_ms']:.4f} ms" if timed else "")
            + f" bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}, "
            f"{entry['bytes'] / 1e9:.3f} GB)")
        del maps, leaves, boxes, idx, levels, dout, out, got
    torch.cuda.empty_cache()
    return report


def fpn_frames(n: int, seed: int):
    """(n, 768, 1344, 3) float32 frames in [0, 1]: dim noise with six flat
    coloured rectangles each."""
    import numpy as np

    rng = np.random.RandomState(seed)
    h, w = FPN_FRAME_HW
    frames = (rng.rand(n, h, w, 3) * 0.25).astype(np.float32)
    for t in range(n):
        for _ in range(6):
            y0, x0 = rng.randint(0, h - 64), rng.randint(0, w - 64)
            hh, ww = rng.randint(32, h // 2), rng.randint(32, w // 2)
            frames[t, y0 : y0 + hh, x0 : x0 + ww] = rng.rand(3)
    return frames


def phase_fpn(dev) -> dict:
    """X101-32x8d-FPN at FPNConfig's defaults (the published widths) on the
    port's main path: detect_video_frames with K7's levels form, then with
    the plain per-level RoIAlign (the same detections apart from
    near-ties); train_detector (shortest-edge 800 / 1333 inputs) with K7
    and with the plain form (step-1 losses within rtol 1e-4, every loss
    finite)."""
    import logging

    import numpy as np

    from tspn_tpu_torch.detection import train as dt
    from tspn_tpu_torch.detection.fpn import FPNConfig, FPNFasterRCNN
    from tspn_tpu_torch.detection.inputs import DetectorTrainConfig
    from tspn_tpu_torch.ops import roi_align as ra
    from tspn_tpu_torch.pipeline import detect_video_frames

    t0 = time.perf_counter()
    cfg = FPNConfig()
    model = FPNFasterRCNN(cfg, generator=torch.Generator().manual_seed(SEED)).to(dev)
    with torch.no_grad():  # so that the 0.05 score threshold keeps detections
        model.cls_score.bias[:DET_RAISED_CLASSES] = DET_RAISED_BIAS
    model = model.to(memory_format=torch.channels_last).eval()
    frames = fpn_frames(FPN_FRAMES, SEED)
    log(f"fpn detect: X{cfg.depth}-{cfg.groups}x{cfg.width_per_group}d-FPN, "
        f"{cfg.num_classes} classes, {FPN_FRAMES} frames of {FPN_FRAME_HW}, batch "
        f"{DET_BATCH}; model and frames made in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats(dev)
    dets = {}
    for variant in ("kernel", "kernel", "plain"):  # the first is a warm-up
        model.roi_pool = (ra.roi_align_levels if variant == "kernel"
                          else roi_align_levels_plain_chunked)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = detect_video_frames(model, frames, device=dev, batch_size=DET_BATCH)
        seconds = time.perf_counter() - t0
        dets[variant] = {k: torch.as_tensor(v) for k, v in out.items()}
        log(f"fpn detect {variant}: {seconds:.2f} s for {FPN_FRAMES} frames (host clock)")
    model.roi_pool = ra.roi_align_levels
    kept = dets["kernel"]["mask"].bool()
    if not bool(kept.any(dim=1).all()) or not bool(torch.isfinite(
            dets["kernel"]["boxes"][kept]).all()):
        raise AssertionError("fpn detect: a frame without detections, or a bad box")
    ties = same_detections_but_ties(dets["kernel"], dets["plain"])
    result = {"detect": {"frames": FPN_FRAMES, "frame_hw": list(FPN_FRAME_HW),
                         "batch": DET_BATCH, "kept_detections": int(kept.sum()),
                         "near_ties_excluded": ties,
                         "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}}
    log(f"fpn detect: {int(kept.sum())} detections kept, every frame keeps some; K7 and "
        f"plain equal apart from {ties} near-tie slots")
    del model, dets
    torch.cuda.empty_cache()

    records = detector_train_records(DET_TRAIN_RECORDS, SEED)
    quiet = logging.getLogger("chip_smoke.fpn_train")
    quiet.setLevel(logging.WARNING)
    train_cfg = DetectorTrainConfig(max_iter=FPN_TRAIN_STEPS, log_every=1,
                                    input_policy="shortest_edge")
    first, rates = {}, {}
    torch.cuda.reset_peak_memory_stats(dev)
    for variant in ("kernel", "plain"):
        model, hist = dt.train_detector(
            records, cfg, train_cfg, seed=SEED, logger=quiet, device=dev,
            roi_pool=None if variant == "kernel" else roi_align_levels_plain_chunked)
        torch.cuda.synchronize()
        losses = hist["losses"]
        if not isinstance(model, FPNFasterRCNN) or len(losses) != FPN_TRAIN_STEPS or not all(
                np.isfinite(v) for step in losses for v in step.values()):
            raise AssertionError(f"fpn train {variant}: bad run, losses {losses}")
        first[variant] = losses[0]
        rates[variant] = 1.0 / statistics.median(hist["step_seconds"][1:])
        del model
        torch.cuda.empty_cache()
    diff = {k: abs(first["kernel"][k] - first["plain"][k]) / abs(first["plain"][k])
            for k in first["plain"]}
    if max(diff.values()) > 1e-4:
        raise AssertionError(f"fpn train: step-1 losses kernel {first['kernel']} plain "
                             f"{first['plain']} beyond rtol 1e-4")
    result["train"] = {"steps": FPN_TRAIN_STEPS, "ims_per_batch": train_cfg.ims_per_batch,
                       "first_losses": first, "step1_rel_diff": diff,
                       "steps_per_s_host_clock": rates,
                       "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    log(f"fpn train: {FPN_TRAIN_STEPS} steps a run, step-1 losses {first['kernel']} (max "
        f"rel diff to plain {max(diff.values()):.3e}); steps/s (host clock) {rates}")
    # launches: one levels forward a detect batch in the two kernel detect
    # runs; one forward and one backward a kernel training step. NMS: two
    # calls a detect batch (the RPN's over all levels, the class-aware) in
    # all three detect runs; one a training step in both training runs
    batches = -(-FPN_FRAMES // DET_BATCH)
    result["want_launches"] = {"roi_align_levels": 2 * batches + FPN_TRAIN_STEPS,
                               "roi_align_levels_backward": FPN_TRAIN_STEPS,
                               "nms": 3 * 2 * batches + 2 * FPN_TRAIN_STEPS}
    return result


def nms_inputs(name: str, dev):
    """One of the cells' NMS calls (tools/nms_cases.py) on the card ->
    (boxes, scores, valid, top_k, threshold)."""
    from tspn_tpu_torch.tools import nms_cases

    b, n, top_k, thr = nms_cases.CELL_SHAPES[name]
    made = (nms_cases.class_aware(SEED, b) if name == "class_aware"
            else nms_cases.rpn_like(SEED, b, n))
    return (*(t.to(dev) for t in made), top_k, thr)


def phase_nms(dev) -> dict:
    """csrc/nms.cu against the blocked loop on the card, bit for bit, at
    the cells' three calls, timed."""
    from tspn_tpu_torch.ops import nms as tnms

    report = {}
    for name in NMS_CASES:
        boxes, scores, valid, top_k, thr = nms_inputs(name, dev)
        before = tnms.LAUNCHES["nms"]
        idx, keep = tnms.nms(boxes, scores, thr, top_k, valid=valid)
        ref_idx, ref_keep = tnms._nms_blocked(boxes, scores, thr, top_k, valid, 16)
        torch.cuda.synchronize()
        if tnms.LAUNCHES["nms"] != before + 1:
            raise AssertionError(f"nms {name}: {tnms.LAUNCHES['nms'] - before} launches")
        if not (torch.equal(idx, ref_idx) and torch.equal(keep, ref_keep)):
            raise AssertionError(f"nms {name}: the kernel differs from the blocked loop")
        masked = torch.where(valid, scores, float("-inf"))
        ms = cuda_median_ms(lambda: tnms.nms(boxes, scores, thr, top_k, valid=valid))
        sort_ms = cuda_median_ms(
            lambda: torch.sort(masked, dim=1, descending=True, stable=True))
        plain_ms = cuda_median_ms(
            lambda: tnms._nms_blocked(boxes, scores, thr, top_k, valid, 16),
            warmup=1, iters=1, reps=3)
        report[name] = {"images": scores.shape[0], "candidates": scores.shape[1],
                        "top_k": top_k, "threshold": thr, "kept": keep.sum(1).tolist(),
                        "max_abs_err": 0.0, "ms": ms, "sort_ms": sort_ms,
                        "plain_ms": plain_ms, **bound((boxes, scores, valid), idx, 0, "f32")}
        log(f"nms {name}: {scores.shape[0]} x {scores.shape[1]} -> {top_k} at {thr}, kept "
            f"{report[name]['kept']}: equal to the blocked loop; call {ms:.4f} ms (sort "
            f"{sort_ms:.4f} ms), blocked loop {plain_ms:.2f} ms")
        del boxes, scores, valid, masked

    return report


def build_kernels() -> None:
    """The eleven sources' nvcc builds (K1 and K6 share q8s_sm90.cu, K4 is
    q8s.cu; Kr, Kn and Ks4 rel.cu; T-roi 1-3 roi_probes.cu), one per source,
    started together."""
    from tspn_tpu_torch.ops import _cuda

    libraries = (_cuda.q8s_sm90_library, _cuda.q8i8_library, _cuda.q8f_fused_library,
                 _cuda.fused_classify_library, _cuda.roi_align_library,
                 _cuda.q8_bf16_library, _cuda.rel_library,
                 _cuda.fused_classify_bf16_library, _cuda.roi_sep_fused_library,
                 _cuda.pair_probe_library, _cuda.nms_library)
    with ThreadPoolExecutor(len(libraries)) as pool:
        for f in [pool.submit(lib) for lib in libraries]:
            f.result()


def report_build(name: str) -> None:
    from tspn_tpu_torch.ops import _cuda

    built = _cuda.build_seconds.get(name)
    log(f"{name} from tspn_tpu_torch/csrc/{name}.cu for sm_90a: " + (
        f"built in {built:.2f} s" if built is not None
        else f"loaded the existing build in {_cuda.BUILD_DIR}"
    ))


def main_path(name: str, fn):
    """Drive one group of main-path phases with every launch count set to
    0 just before and read just after -> (fn's result, counts)."""
    from tspn_tpu_torch.ops import nms as tnms
    from tspn_tpu_torch.ops import pairwise as pw
    from tspn_tpu_torch.ops import rel
    from tspn_tpu_torch.ops import roi_align as ra
    from tspn_tpu_torch.ops import roi_probes as rp

    for module in (pw, ra, rel, rp, tnms):
        module.reset_launches()
    result = fn()
    counts = {**pw.LAUNCHES, **ra.LAUNCHES, **rel.LAUNCHES, **rp.LAUNCHES, **tnms.LAUNCHES}
    log(f"main path {name}: launches {counts}")
    return result, counts


def kernel_entry(name: str, source: str, replaces: str, launches: int,
                 checks: dict, timed: str, **extra) -> dict:
    """One entry of the kernels line: the largest error over the checked
    geometries, and the times and bound at the geometry ``timed``. Only
    the probe and Kr (int32) have a library time (``torch._int_mm``, where
    it accepts the shapes), K3 f32 ``torch.matmul`` of rows normalized
    beforehand (the product alone), K1 and K6 ``torch._int_mm`` of the same rows
    (their int32 product without the segment fold, the nearest single
    call), and selector and constg (``torch.matmul`` with their G
    materialized): PyTorch has no int4 product for Kn and Ks4, and no
    single PyTorch call computes the other kernels' functions (they scale
    segments of an int32 or bf16 product by per-row scales; for RoIAlign,
    ``F.grid_sample``'s zero padding splits the weight at the border where
    torchvision's rule clamps [-1, 0] to index 0 at full weight)."""
    c = checks[timed]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(v["max_abs_err"] for v in checks.values()),
            "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c.get("library_ms"), **extra}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from tspn_tpu_torch.data.synthetic import synthetic_segments

    # plain versions and the detector's convolutions in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    build_kernels()
    report_build("q8s_sm90")
    report_build("q8s")
    checks = phase_kernel_check(dev)
    report_build("q8f_fused")
    k2_checks = phase_k2_check(dev)

    t0 = time.perf_counter()
    data = {mode: synthetic_segments(NUM_SEGMENTS, mode, seed=SEED,
                                     num_objects=SERVE["num_objects"],
                                     num_predicates=NUM_PREDICATES)
            for mode in ("q8f", "q8")}
    log(f"serve: q8f and q8 sets of {NUM_SEGMENTS} segments generated in "
        f"{time.perf_counter() - t0:.1f} s")
    q8f_launches = {"q8s": 1, "q8f_fused": 1}

    def serve_int8(ppn: bool, **extra):
        model = seeded_model(dev, ppn=ppn)
        tag = "_pruned" if ppn else ""
        return {
            f"q8f{tag}": phase_serve(f"q8f{tag}", data["q8f"], model, dev,
                                     q8f_launches, **extra),
            f"q8{tag}": phase_serve(f"q8{tag}", data["q8"], model, dev,
                                    {"q8s": 1}, **extra),
        }

    serve, counts_int8 = main_path("q8f + q8 serve", lambda: serve_int8(False))

    report_build("fused_classify")
    fused_checks = phase_fused_check(dev)
    t0 = time.perf_counter()
    fused_data = synthetic_segments(FUSED_SEGMENTS, "f32dev", seed=SEED,
                                    num_objects=SERVE["num_objects"],
                                    num_predicates=NUM_PREDICATES)
    log(f"fused: {FUSED_SEGMENTS} labeled segments generated in "
        f"{time.perf_counter() - t0:.1f} s")

    def fused():
        served = phase_serve(
            "fused_f32", fused_data, seeded_fused_model(dev, inference=True).eval(),
            dev, {"fused_classify": 1}, compare=same_selection_but_ties,
        )
        return served, phase_train("fused", fused_data, dev)

    (serve["fused_f32"], train), counts_fused = main_path("fused serve + train", fused)
    want = (serve["fused_f32"]["batches"] * KERNEL_SERVE_RUNS + 2 * TRAIN_STEPS
            + PROFILED_STEPS)
    if counts_fused["fused_classify"] != want:
        raise AssertionError(
            f"fused_classify launches {counts_fused['fused_classify']}, want {want}: "
            f"{serve['fused_f32']['batches']} batches x {KERNEL_SERVE_RUNS} kernel serve "
            f"runs (warm-up, four timed, two profiled) + 2 x {TRAIN_STEPS} + "
            f"{PROFILED_STEPS} kernel training steps"
        )

    def ppn():
        served = serve_int8(True, num_pair_proposals=NUM_PAIR_PROPOSALS)
        return served, phase_train("fused_ppn", fused_data, dev, ppn=True)

    (served_ppn, train_ppn), counts_ppn = main_path("PPN serve + train", ppn)
    serve.update(served_ppn)

    report_build("roi_align")
    k7_checks = phase_k7_check(dev)
    detect, counts_det = main_path("detector", lambda: phase_detect(dev))
    if counts_det["roi_align"] != detect["want_launches"]:
        raise AssertionError(f"roi_align launches {counts_det['roi_align']}, want "
                             f"{detect['want_launches']}")
    if counts_det["nms"] != detect["want_nms_launches"]:
        raise AssertionError(f"nms launches {counts_det['nms']}, want "
                             f"{detect['want_nms_launches']}")

    report_build("q8s_sm90")
    report_build("q8s")
    report_build("q8_bf16")
    report_build("pair_probe")
    variant_checks = phase_variant_check(dev)
    tool, counts_tool = main_path("bench_pair_kernels", lambda: phase_tool(dev))
    per_leg = WARMUP + ITERS * REPS  # one launch per timed call of a leg
    want_tool = {"q8s": per_leg, "q8_probe": 3 * per_leg, "q8t": per_leg}
    if {k: v for k, v in counts_tool.items() if v} != want_tool:
        raise AssertionError(f"bench_pair_kernels launches {counts_tool}, want {want_tool}")

    report_build("rel")
    rel_checks = phase_rel_check(dev)
    rel_tools, counts_rel = main_path("bench_rel tools", lambda: phase_rel_tools(dev))
    want_rel = rel_tool_launches(rel_tools)
    if {k: v for k, v in counts_rel.items() if v} != want_rel:
        raise AssertionError(f"bench_rel tools launches {counts_rel}, want {want_rel}")
    torch.cuda.empty_cache()

    report_build("fused_classify_bf16")
    k3b_checks = phase_k3_bf16_check(dev)
    t0 = time.perf_counter()
    unfused_data = synthetic_segments(FUSED_SEGMENTS, "f32", seed=SEED,
                                      num_objects=SERVE["num_objects"],
                                      num_predicates=NUM_PREDICATES)
    log(f"bf16: {FUSED_SEGMENTS} storage-layout segments generated in "
        f"{time.perf_counter() - t0:.1f} s")
    bf16 = torch.bfloat16

    def bf16_model():
        fused_model = seeded_fused_model(dev, inference=True, dtype=bf16).eval()
        served = {
            "fused_bf16": phase_serve(
                "fused_bf16", fused_data, fused_model, dev, {"fused_classify_bf16": 1},
                compare=lambda k, p: same_selection_but_ties(k, p, TIE_TOL_BF16)),
            "unfused_bf16": phase_serve("unfused_bf16", unfused_data,
                                        seeded_model(dev, dtype=bf16), dev, {}),
        }
        return served, phase_train("fused_bf16", fused_data, dev, dtype=bf16,
                                   rtol=(1e-3, 1e-2))

    (served_bf16, train_bf16), counts_bf16 = main_path("bf16 serve + train", bf16_model)
    serve.update(served_bf16)
    want = (served_bf16["fused_bf16"]["batches"] * KERNEL_SERVE_RUNS + 2 * TRAIN_STEPS
            + PROFILED_STEPS)
    if counts_bf16["fused_classify_bf16"] != want or counts_bf16["fused_classify"]:
        raise AssertionError(f"bf16 launches {counts_bf16}: want {want} fused_classify_bf16 "
                             "and no f32 fused_classify")
    del unfused_data
    torch.cuda.empty_cache()

    report_build("roi_probes")
    roi_checks = phase_roi_check(dev)
    roi_tools, counts_roi = main_path("RoIAlign probe tools", lambda: phase_roi_tools(dev))
    per_call = 1 + WARMUP + ITERS * REPS  # the check call and each timed call
    want_roi = {"roi_sep_fused": 2 * per_call, "roi_selector": 2 * per_call,
                "roi_constg": 2 * per_call, "roi_align": per_call, "roi_align_bf16": per_call}
    if {k: v for k, v in counts_roi.items() if v} != want_roi:
        raise AssertionError(f"RoIAlign probe tools launches {counts_roi}, want {want_roi}")

    report_build("roi_align")
    from tspn_tpu_torch.ops import _cuda

    _cuda.roi_align_bf16_library()
    _cuda.roi_align_backward_library()
    log("roi_align.cu entry points tspn_roi_align_bf16_launch and "
        "tspn_roi_align_backward_launch bound")
    k7b_checks = phase_k7_bf16_check(dev)
    k7g_checks = phase_k7_backward_check(dev)

    def detector_train_and_bf16_serve():
        return phase_detector_train(dev), phase_detect(dev, torch.bfloat16)

    (det_train, detect_bf16), counts_train = main_path("detector training + bf16 detect",
                                                       detector_train_and_bf16_serve)
    # per kernel training run: one forward and one backward a step; the
    # traced step and its warm-up likewise; the traced f32 loop's steps
    # likewise; the reloaded checkpoint's detect batch one f32 forward. NMS:
    # one RPN call a training step in every run, plain RoIAlign's too, in
    # f32 and bf16; the reloaded checkpoint's detect batch two
    steps = 2 * DET_TRAIN_STEPS + 2
    want_train = {"roi_align": steps + DET_TRAIN_TRACED_STEPS + 1,
                  "roi_align_bf16": steps + detect_bf16["want_launches"],
                  "roi_align_backward": 2 * steps + DET_TRAIN_TRACED_STEPS,
                  "nms": 2 * (4 * DET_TRAIN_STEPS + 2) + DET_TRAIN_TRACED_STEPS + 2
                  + detect_bf16["want_nms_launches"]}
    if {k: v for k, v in counts_train.items() if v} != want_train:
        raise AssertionError(f"detector training + bf16 detect launches {counts_train}, "
                             f"want {want_train}")
    log(f"nms launches on the main path: {counts_det['nms']} (phase 15) and "
        f"{counts_train['nms']} (phases 28-29), as expected from two a detect batch, one a "
        "training step and one more a TTA call")
    for kernel, counts in (("q8s", (counts_int8, counts_ppn, counts_tool, counts_rel)),
                           ("q8f_fused", (counts_int8, counts_ppn)),
                           ("fused_classify", (counts_fused, counts_ppn)),
                           ("roi_align", (counts_det, counts_train)),
                           ("roi_align_bf16", (counts_roi, counts_train)),
                           ("roi_align_backward", (counts_train,)),
                           ("nms", (counts_det, counts_train)),
                           ("q8t", (counts_tool,)), ("q8_probe", (counts_tool,)),
                           ("rel_s8", (counts_rel,)), ("rel_s4x8", (counts_rel,)),
                           ("rel_s4x4", (counts_rel,)), ("fused_classify_bf16", (counts_bf16,)),
                           ("roi_sep_fused", (counts_roi,)), ("roi_selector", (counts_roi,)),
                           ("roi_constg", (counts_roi,))):
        if any(c[kernel] == 0 for c in counts):
            raise AssertionError(f"a main-path phase launched no {kernel} kernel")
    report_build("nms")
    nms_checks = phase_nms(dev)

    report_build("roi_align")
    _cuda.roi_align_levels_library()
    _cuda.roi_align_levels_backward_library()
    log("roi_align.cu entry points tspn_roi_align_levels_launch and "
        "tspn_roi_align_levels_backward_launch bound")
    k7l_checks = phase_k7_levels_check(dev)
    fpn, counts_fpn = main_path("X101-FPN detect + train", lambda: phase_fpn(dev))
    if {k: v for k, v in counts_fpn.items() if v} != fpn["want_launches"]:
        raise AssertionError(f"X101-FPN detect + train launches {counts_fpn}, want "
                             f"{fpn['want_launches']}")
    all_counts = (counts_int8, counts_fused, counts_ppn, counts_det, counts_tool, counts_rel,
                  counts_bf16, counts_roi, counts_train, counts_fpn)
    launches = {k: sum(c[k] for c in all_counts) for k in counts_int8}
    checked = variant_checks.pop("check_launches")
    rel_checked = rel_checks.pop("check_launches")

    log(smi)
    log(json.dumps({"serve": serve, "train_fused": train, "train_fused_ppn": train_ppn,
                    "q8s_q8t_geometries": checks, "q8f_fused_geometries": k2_checks,
                    "fused_geometries": fused_checks, "detector": detect,
                    "roi_align_geometries": k7_checks,
                    "variant_geometries": variant_checks, "variant_check_launches": checked,
                    "bench_pair_kernels": tool,
                    "rel_geometries": rel_checks, "rel_check_launches": rel_checked,
                    "bench_rel_tools": rel_tools, "train_fused_bf16": train_bf16,
                    "fused_bf16_geometries": k3b_checks, "roi_probe_geometries": roi_checks,
                    "bench_roialign_tools": roi_tools,
                    "roi_align_bf16_geometries": k7b_checks,
                    "roi_align_backward_geometries": k7g_checks,
                    "detector_train": det_train, "detector_bf16": detect_bf16,
                    "nms_geometries": nms_checks,
                    "roi_align_levels_geometries": k7l_checks, "detector_fpn": fpn,
                    "main_path_launches": {"int8_serve": counts_int8,
                                           "fused": counts_fused, "ppn": counts_ppn,
                                           "detector": counts_det,
                                           "bench_pair_kernels": counts_tool,
                                           "bench_rel_tools": counts_rel,
                                           "bf16": counts_bf16,
                                           "bench_roialign_tools": counts_roi,
                                           "detector_train_bf16_detect": counts_train,
                                           "detector_fpn": counts_fpn}}))
    log(json.dumps({"kernels": [
        kernel_entry("q8s", "tspn_tpu_torch/csrc/q8s_sm90.cu",
                     "tspn_tpu/ops/pairwise.py:481", launches["q8s"], checks["q8s"], "rel"),
        kernel_entry("fused_classify", "tspn_tpu_torch/csrc/fused_classify.cu",
                     "tspn_tpu/ops/pairwise.py:1288", launches["fused_classify"],
                     fused_checks, "train",
                     f32_cuda_core_bound_ms=fused_checks["train"]["f32_cuda_core_bound_ms"],
                     worst_err_over_bound=max(v["worst_err_over_bound"]
                                              for v in fused_checks.values())),
        kernel_entry("q8f_fused", "tspn_tpu_torch/csrc/q8f_fused.cu",
                     "tspn_tpu/ops/pairwise.py:1071", launches["q8f_fused"],
                     k2_checks, "serve"),
        kernel_entry("roi_align", "tspn_tpu_torch/csrc/roi_align.cu",
                     "tspn_tpu/ops/roi_align.py:171", launches["roi_align"],
                     k7_checks, "detect"),
        kernel_entry("roi_align_bf16", "tspn_tpu_torch/csrc/roi_align.cu",
                     "tspn_tpu/ops/roi_align.py:171", launches["roi_align_bf16"],
                     k7b_checks, "detect"),
        kernel_entry("nms", "tspn_tpu_torch/csrc/nms.cu",
                     "none (tspn_tpu/ops/nms.py::nms is a lax.while_loop)",
                     launches["nms"], nms_checks, "rpn_train",
                     sort_ms=nms_checks["rpn_train"]["sort_ms"]),
        kernel_entry("roi_align_backward", "tspn_tpu_torch/csrc/roi_align.cu",
                     "tspn_tpu/ops/roi_align.py:171", launches["roi_align_backward"],
                     k7g_checks["f32"], "train",
                     bf16={"max_abs_err": max(v["max_abs_err"]
                                              for v in k7g_checks["bf16"].values()),
                           **{k: k7g_checks["bf16"]["train"][k] for k in
                              ("ms", "plain_ms", "bound_ms", "bound_by")}}),
        kernel_entry("roi_align_levels", "tspn_tpu_torch/csrc/roi_align.cu",
                     "none (the JAX package has no FPN)", launches["roi_align_levels"],
                     k7l_checks["forward"], "detect"),
        kernel_entry("roi_align_levels_backward", "tspn_tpu_torch/csrc/roi_align.cu",
                     "none (the JAX package has no FPN)",
                     launches["roi_align_levels_backward"], k7l_checks["backward"], "train",
                     worst_err_over_bound=max(v["worst_err_over_bound"]
                                              for v in k7l_checks["backward"].values())),
        kernel_entry("q8i8", "tspn_tpu_torch/csrc/q8s.cu",
                     "tspn_tpu/ops/pairwise.py:571", launches["q8i8"],
                     variant_checks["q8i8"], "tool", check_launches=checked["q8i8"]),
        kernel_entry("q8bf", "tspn_tpu_torch/csrc/q8_bf16.cu",
                     "tspn_tpu/ops/pairwise.py:346", launches["q8bf"],
                     variant_checks["q8bf"], "tool", check_launches=checked["q8bf"]),
        kernel_entry("q8t", "tspn_tpu_torch/csrc/q8s_sm90.cu",
                     "tspn_tpu/ops/pairwise.py:1210", launches["q8t"],
                     {**checks["q8t"], **{f"{k}_variants": v for k, v in
                                          variant_checks["q8t"].items()}}, "tool",
                     check_launches=checked["q8t"]),
        kernel_entry("q8_probe", "tspn_tpu_torch/csrc/pair_probe.cu",
                     "tools/bench_pair_kernels.py:111", launches["q8_probe"],
                     variant_checks["q8_probe"], "tool", check_launches=checked["q8_probe"],
                     library_refused=variant_checks["q8_probe"]["tool"].get("library_refused")),
        kernel_entry("rel_s8", "tspn_tpu_torch/csrc/rel.cu",
                     "tools/bench_rel_steps.py:91,102,113; tools/bench_rel_pipeline.py:91,155,207;"
                     " tools/bench_rel_probe.py:69,130,243; tools/bench_rel_int4.py:63,76",
                     launches["rel_s8"], rel_checks["rel_s8"], "tool",
                     check_launches=rel_checked["rel_s8"]),
        kernel_entry("rel_s4x8", "tspn_tpu_torch/csrc/rel.cu",
                     "tools/bench_rel_probe.py:166,276; tools/bench_rel_int4.py:63,76",
                     launches["rel_s4x8"], rel_checks["rel_s4x8"], "tool",
                     check_launches=rel_checked["rel_s4x8"]),
        kernel_entry("rel_s4x4", "tspn_tpu_torch/csrc/rel.cu", "tools/bench_rel_int4.py:63,76",
                     launches["rel_s4x4"], rel_checks["rel_s4x4"], "tool",
                     check_launches=rel_checked["rel_s4x4"]),
        kernel_entry("fused_classify_bf16", "tspn_tpu_torch/csrc/fused_classify_bf16.cu",
                     "tspn_tpu/ops/pairwise.py:1288", launches["fused_classify_bf16"],
                     k3b_checks, "train"),
        *(kernel_entry(name, "tspn_tpu_torch/csrc/roi_probes.cu", replaces,
                       launches[name], roi_checks[name], "f32",
                       bf16={k: roi_checks[name]["bf16"][k] for k in
                             ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
          for name, replaces in (("roi_sep_fused", "tools/bench_roialign_fused.py:94"),
                                 ("roi_selector", "tools/bench_roialign_variants.py:137"),
                                 ("roi_constg", "tools/bench_roialign_variants.py:182"))),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
