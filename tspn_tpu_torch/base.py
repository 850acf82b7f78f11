"""Command line of the PyTorch port: ``python -m tspn_tpu_torch.base``.

Takes the flags of the JAX package's ``base.py`` plus ``--device``.
``--train [--resume]`` trains the segment-mode relation model, with the
PPN pair head under ``RELPN.USE_PPN`` (unfused, or fused with
``MODEL.FUSED_CLASSIFIER``), and writes ``<name>_weights_iter_<N>.pt``
under ``<OUTPUT_DIR>/models``. ``--detect`` runs segment-mode relation
detection, PPN-pruned under ``RELPN.PPN.PRUNE_AT_INFERENCE``, and writes
``<OUTPUT_DIR>/models/baseline_relation_prediction.json`` with the same
contract; it serves the port's checkpoints and those of ``base.py
--train``. ``--preprocess`` and span mode (``RELPN.USE_DPN``) are not
ported yet: run them with ``base.py``.

Both run on ``--device cuda`` unless another device is named
(``--device cpu`` runs every kernel's plain version). Config parsing,
dataset readers, greedy association and logging are the port's own
copies of the JAX package's host code; reading YAML and h5 files needs
PyYAML and h5py, imported where a file is read.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict


def _build_basedata(dataset: str, data_dir: str):
    from tspn_tpu_torch.data.annotations import BaseVidOR, BaseVidVRD

    if dataset == "vidvrd":
        return BaseVidVRD(data_dir, os.path.join(data_dir, "videos"), ["train", "test"])
    if dataset == "vidor":
        return BaseVidOR(
            os.path.join(data_dir, "annotation"),
            os.path.join(data_dir, "videos"),
            ["training", "validation"],
        )
    raise ValueError(f"No dataset named {dataset}")


def detect(cfg, args, data_dir) -> str:
    from tspn_tpu_torch import association
    from tspn_tpu_torch.data.segments import get_model_path
    from tspn_tpu_torch.runtime.logging_utils import get_timestamp, setup_logger
    from tspn_tpu_torch.runtime.predict import predict

    if cfg.RELPN.USE_DPN:
        raise NotImplementedError(
            "span mode (RELPN.USE_DPN) is not ported yet (ROADMAP queue 1, "
            "slice 2); run base.py --detect"
        )
    basedata = _build_basedata(args.dataset, data_dir)
    logger = setup_logger("detect", "logs", 0, f"{get_timestamp()}_detect.txt")
    logger.info(f"predict short term relations on {args.device}")
    short_term_relations = predict(cfg, basedata, args.device, logger)

    video_st_relations = defaultdict(list)
    for index, st_rel in short_term_relations.items():
        video_st_relations[index[0]].append((index, st_rel))
    logger.info("video-level visual relation detection by greedy relational association")
    video_relations = {
        vid: association.greedy_relational_association(
            basedata, rels, max_traj_num_in_clip=100
        )
        for vid, rels in video_st_relations.items()
    }
    out_path = os.path.join(get_model_path(), "baseline_relation_prediction.json")
    with open(out_path, "w") as f:
        json.dump({"version": "VERSION 1.0", "results": video_relations}, f)
    logger.info(f"wrote {out_path}")
    return out_path


def training(cfg, args, data_dir):
    from tspn_tpu_torch.runtime.logging_utils import get_timestamp, setup_logger
    from tspn_tpu_torch.runtime.train import train

    if cfg.RELPN.USE_DPN:
        raise NotImplementedError(
            "span mode (RELPN.USE_DPN) is not ported yet (ROADMAP queue 1, "
            "slice 2); run base.py --train"
        )
    basedata = _build_basedata(args.dataset, data_dir)
    logger = setup_logger("train", "logs", 0, f"{get_timestamp()}_train.txt")
    return train(cfg, basedata, args.device, resume=args.resume, logger=logger)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="VidVRD TSPN (PyTorch port)")
    parser.add_argument("--config", type=str, default="configs/baseline.yaml")
    parser.add_argument("--data_dir", type=str, help="dataset directory")
    parser.add_argument("--dataset", type=str, help="the dataset name")
    parser.add_argument("--preprocess", action="store_true", help="Preprocess dataset")
    parser.add_argument("--train", action="store_true", help="Train model")
    parser.add_argument("--detect", action="store_true", help="Detect video visual relation")
    parser.add_argument("--resume", action="store_true", help="Resume from latest checkpoint")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device for --train and --detect (default cuda; "
                             "cpu runs the kernels' plain versions)")
    parser.add_argument("--nodes", type=int, default=1)
    parser.add_argument("--ngpus_per_node", type=int, default=1)
    parser.add_argument("--local_rank", type=int, default=0)
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    if not (args.train or args.detect or args.preprocess):
        parser.print_help()
        return 0
    if args.preprocess:
        print(
            "--preprocess is not ported to PyTorch yet; run it with base.py "
            "(the JAX package). --train and --detect here read its artifacts.",
            file=sys.stderr,
        )
        return 2
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {args.device}: no CUDA device is available "
                     "(pass --device cpu to run on the CPU)")
    from tspn_tpu_torch.config import get_default_config
    from tspn_tpu_torch.data.segments import set_output_dir

    cfg = get_default_config()
    cfg.merge_from_file(args.config)
    set_output_dir(cfg.ETC.OUTPUT_DIR)
    data_dir = os.path.join(args.data_dir, args.dataset)
    if args.train:
        training(cfg, args, data_dir)
    if args.detect:
        detect(cfg, args, data_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
