"""Detector training CLI (port of tools/train_detector.py).

    python -m tspn_tpu_torch.tools.train_detector --data_dir data [--dataset vidvrd]
        [--split train] [--image_root image] [--max_iter 100000] [--ims_per_batch 4]
        [--base_lr 2.5e-4] [--input_policy letterbox|shortest_edge] [--image_size 640]
        [--min_size 800] [--max_size 1333] [--arch r-c4|x-fpn] [--depth 101]
        [--eval_split SPLIT] [--eval_every 5000] [--eval_max_images 500]
        [--output PATH] [--bf16] [--device cuda]

Registers the VidVRD / VidOR frames in COCO format and trains Faster R-CNN
with the reference recipe (IMS_PER_BATCH 4, lr 2.5e-4, 100k iterations,
ROI batch 128), optionally evaluating on a held-out split and keeping the
best checkpoint. ``--arch`` picks the detector: ``r-c4`` (the default)
is R101-C4, ``x-fpn`` ResNeXt-101 32x8d with an FPN (float32 only).
``--bf16`` computes the R-C4 detector in bfloat16 over float32
parameters. ``--output`` receives the port's training checkpoint
(torch.save: parameters, SGD momentum, LR schedule, step), which
``runtime.checkpoint.load_detector_checkpoint`` reads.

``--device`` defaults to ``cuda`` and stops with a hint when there is no
card; ``--device cpu`` trains through the plain RoIAlign. The JAX tool's
``--num_machines`` / ``--machine_rank`` / ``--dist_url`` are accepted;
more than one machine raises (multi-GPU is not ported yet).
"""

from __future__ import annotations

import argparse
import os

import torch

from tspn_tpu_torch.data.vocab import VIDOR_OBJECTS, VIDVRD_OBJECTS
from tspn_tpu_torch.detection.coco_format import (
    vidor_to_coco_format,
    vidvrd_to_coco_format,
)
from tspn_tpu_torch.detection.fpn import FPNConfig
from tspn_tpu_torch.detection.inputs import DetectorTrainConfig
from tspn_tpu_torch.detection.rcnn import DetectionConfig
from tspn_tpu_torch.detection.train import launch, train_detector


def _load_records(args, split):
    root = os.path.join(args.data_dir, args.dataset)
    if args.dataset == "vidvrd":
        return vidvrd_to_coco_format(root, split, args.image_root)
    return vidor_to_coco_format(os.path.join(root, "annotation"), split, args.image_root)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train Faster R-CNN (R101-C4 or X101-FPN)")
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--dataset", choices=["vidvrd", "vidor"], default="vidvrd")
    parser.add_argument("--split", default="train")
    parser.add_argument("--image_root", default="image")
    parser.add_argument("--max_iter", type=int, default=100000)
    parser.add_argument("--ims_per_batch", type=int, default=4)
    parser.add_argument("--base_lr", type=float, default=2.5e-4)
    parser.add_argument("--input_policy", choices=["letterbox", "shortest_edge"],
                        default="letterbox")
    parser.add_argument("--image_size", type=int, default=640,
                        help="square letterbox target (letterbox policy)")
    parser.add_argument("--min_size", type=int, default=800)
    parser.add_argument("--max_size", type=int, default=1333)
    parser.add_argument("--arch", choices=["r-c4", "x-fpn"], default="r-c4",
                        help="R101-C4, or ResNeXt-101 32x8d with an FPN")
    parser.add_argument("--depth", type=int, default=101)
    parser.add_argument("--eval_split", default=None,
                        help="held-out split for in-training evaluation")
    parser.add_argument("--eval_every", type=int, default=5000)
    parser.add_argument("--eval_max_images", type=int, default=500)
    parser.add_argument("--output", default="./vidvrd-baseline-output/models/detector.pt")
    # multi-machine launch (detectron2 launch() contract)
    parser.add_argument("--num_machines", type=int, default=1)
    parser.add_argument("--machine_rank", type=int, default=0)
    parser.add_argument("--dist_url", default=None)
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 activations, f32 params/grads")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain RoIAlign)")
    args = parser.parse_args(argv)
    if args.arch == "x-fpn" and args.bf16:
        parser.error("--arch x-fpn computes in float32: drop --bf16")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {args.device}: no CUDA device is available "
                     "(pass --device cpu to run on the CPU)")
    return args


def main(argv=None):
    args = parse_args(argv)
    records = _load_records(args, args.split)
    num_classes = len(VIDVRD_OBJECTS) if args.dataset == "vidvrd" else len(VIDOR_OBJECTS)
    eval_records = None
    if args.eval_split:
        eval_records = _load_records(args, args.eval_split)[: args.eval_max_images]

    config = FPNConfig if args.arch == "x-fpn" else DetectionConfig
    det_cfg = config(num_classes=num_classes, depth=args.depth)
    train_cfg = DetectorTrainConfig(
        ims_per_batch=args.ims_per_batch,
        base_lr=args.base_lr,
        max_iter=args.max_iter,
        image_size=args.image_size,
        input_policy=args.input_policy,
        min_size=args.min_size,
        max_size=args.max_size,
        eval_every=args.eval_every if eval_records else 0,
        mixed_precision=args.bf16,
    )

    def run():
        return train_detector(records, det_cfg, train_cfg, device=args.device,
                              checkpoint_path=args.output, eval_records=eval_records)

    return launch(run, args.num_machines, args.machine_rank, args.dist_url)


if __name__ == "__main__":
    main()
