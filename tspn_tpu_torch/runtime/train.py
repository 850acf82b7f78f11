"""Training loop (counterpart of tspn_tpu/runtime/train.py), on one device.

``train_segments`` is the loop: a shuffled bucketed loader over a
labeled dataset, one ``train_step`` per batch, the plateau scheduler fed
with each step's loss when it is selected, and periodic checkpoints
through a callback. It reads only what the loader contract asks of the
dataset, so it trains from in-memory segments as well as from the
artifacts. A model that computes in bf16 (``MODEL.DTYPE: bfloat16``)
gets bf16 feature leaves. ``train`` is the CLI entry: it reads the train split through
the port's dataset readers (data/vrdataset.py, data/preprocess.py; they
import h5py where they read), builds the model (with the PPN head under
``RELPN.USE_PPN``), resumes from the port's own latest checkpoint when
asked, and saves ``<name>_weights_iter_<N>.pt`` as the JAX package does.

Deviations from the JAX loop: no device mesh (the step batch is
SEGMENTS_PER_STEP segments), and the plateau state is checkpointed and
restored on resume, which the JAX package does not do.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import torch

from tspn_tpu_torch.data.loader import BucketedLoader
from tspn_tpu_torch.parallel.train_step import batch_to_device, train_keys, train_step
from tspn_tpu_torch.solver.optim import ReduceOnPlateauState, build_optimizer


@dataclass
class TrainResult:
    step: int                      # global iteration reached
    losses: List[float]            # per-step total loss of this run
    seconds: float                 # host wall time of the loop, synchronized
    plateau: Optional[ReduceOnPlateauState]
    model: torch.nn.Module = field(repr=False)
    # per-step value of each loss term (loss_rel, and loss_pair with PPN)
    loss_terms: Dict[str, List[float]] = field(default_factory=dict)


def train_segments(
    model, dataset, *, solver, max_iter: int, device,
    buckets: Sequence[int] = (8, 16, 24, 32), batch_size: int = 8,
    seed: int = 0, num_objects: int = 35, feature_dim: Optional[int] = None,
    resume: Optional[dict] = None,
    save: Optional[Callable[[int, float, object, object, object], None]] = None,
    save_freq: int = 0, display_freq: int = 0, logger=None, plain: bool = False,
) -> TrainResult:
    """Train ``model`` (already on ``device``) for the stream positions
    ``[start, max_iter)`` of a loader seeded with ``seed``; start is 0,
    or the step of ``resume`` (a ``load_training_checkpoint`` result
    whose weights the caller has loaded into ``model``).

    ``solver`` is the config's SOLVER subtree. ``save(step, loss,
    optimizer, scheduler, plateau)`` is called every ``save_freq`` steps;
    ``loss`` is the mean step loss of this run so far. ``plain=True``
    runs the plain version of every kernel. Losses are read back to the
    host only at display steps, for the plateau scheduler, and at the end.
    """
    model.train()
    optimizer, scheduler = build_optimizer(solver, model)
    plateau = ReduceOnPlateauState() if solver.SCHEDULER.TYPE == "plateau" else None
    start = 0
    if resume is not None:
        optimizer.load_state_dict(resume["optimizer"])
        scheduler.load_state_dict(resume["scheduler"])
        if plateau is not None and resume.get("plateau") is not None:
            plateau = ReduceOnPlateauState(**resume["plateau"])
        start = int(resume["step"])
    if feature_dim is None:
        feature_dim = dataset.feature_width()
    loader = BucketedLoader(
        dataset, buckets, batch_size, feature_dim, num_objects,
        max_iter=max_iter, shuffle=True, seed=seed, skip_batches=start,
        include_labels=True, feats_dtype=getattr(model, "compute_dtype", torch.float32),
    )

    losses: List[torch.Tensor] = []
    terms: Dict[str, List[torch.Tensor]] = {}

    def mean_loss() -> float:
        return float(torch.stack(losses).mean()) if losses else 0.0

    keys = train_keys(model)
    step = start
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else None
    t0 = time.perf_counter()
    for it, (_bucket, batch, _indices, _records) in enumerate(loader):
        step = start + it + 1
        metrics = train_step(
            model, optimizer, scheduler, batch_to_device(batch, device, keys),
            lr_scale=None if plateau is None else plateau.lr_scale, plain=plain,
        )
        losses.append(metrics["loss"])
        for k, v in metrics.items():
            if k != "loss":
                terms.setdefault(k, []).append(v)
        if plateau is not None:
            plateau = plateau.update(float(metrics["loss"]))
        if logger is not None and display_freq and it % display_freq == 0:
            logger.info(
                f"[{step}/{max_iter}]  loss: {float(metrics['loss']):.4f} "
                f"({mean_loss():.4f})  lr: {optimizer.param_groups[0]['lr']:.6f}"
            )
        if save is not None and save_freq and step % save_freq == 0:
            save(step, mean_loss(), optimizer, scheduler, plateau)
    if sync is not None:
        sync()
    seconds = time.perf_counter() - t0
    if save is not None:
        save(max_iter, mean_loss(), optimizer, scheduler, plateau)
    def host(values):
        return [float(v) for v in torch.stack(values).cpu()] if values else []

    return TrainResult(
        step=step, losses=host(losses), seconds=seconds, plateau=plateau,
        model=model, loss_terms={k: host(v) for k, v in terms.items()},
    )


def train(cfg, basedata, device, resume: bool = False, logger=None,
          init_state_dict: Optional[dict] = None) -> TrainResult:
    """CLI entry, counterpart of the JAX package's ``train``. The model
    starts from ``init_state_dict`` when given (e.g. the JAX init carried
    across with ``state_dict_from_jax``), else from a torch init seeded
    with ETC.RANDOM_SEED. ``--resume`` continues from the latest of the
    port's own checkpoints under the model path."""
    from tspn_tpu_torch.data.segments import get_model_path
    from tspn_tpu_torch.data.vrdataset import SegmentDataset, effective_feature_dim
    from tspn_tpu_torch.models.tspn import build_model_from_config
    from tspn_tpu_torch.runtime.checkpoint import (
        latest_checkpoint,
        load_training_checkpoint,
        save_checkpoint,
    )
    from tspn_tpu_torch.runtime.logging_utils import setup_logger

    if logger is None:
        logger = setup_logger("train", save_dir="logs")
    logger.info(f"config:\n{cfg.dump()}")

    dataset = None
    if str(cfg.PREDICT.get("CONSOLIDATED", "") or "") == "f32":
        from tspn_tpu_torch.data.preprocess import (
            ConsolidatedSegmentDataset,
            consolidated_path,
        )

        for split in ("train", "training"):
            path = consolidated_path(split)
            if os.path.exists(path):
                dataset = ConsolidatedSegmentDataset(cfg, path)
                if dataset.quantized or (
                        dataset.feature_width() != effective_feature_dim(cfg)):
                    raise ValueError(
                        f"{path} does not hold f32 rows of width "
                        f"{effective_feature_dim(cfg)}; re-run --preprocess with "
                        "PREDICT.CONSOLIDATED='f32' and this config"
                    )
                logger.info(f"training from consolidated store: {path}")
                break
    if dataset is None:
        dataset = SegmentDataset(cfg, basedata, phase="train")
    if len(dataset) == 0:
        raise ValueError("no train segments with cached features found")

    model = build_model_from_config(cfg, seed=cfg.ETC.RANDOM_SEED)
    if init_state_dict is not None:
        model.load_state_dict(init_state_dict)
    restored = None
    name = cfg.MODEL.NAME
    if resume:
        ckpt = latest_checkpoint(get_model_path(), name)
        if ckpt:
            restored = load_training_checkpoint(ckpt)
            model.load_state_dict(restored["state_dict"])
            logger.info(f"resumed from {ckpt} at iter {restored['step']}")
    model.to(device)

    def save(step, loss, optimizer, scheduler, plateau):
        fname = f"{name}_weights_iter_{step}.pt"
        cfg.ETC.MODEL_DUMP_FILE = fname
        path = os.path.join(get_model_path(), fname)
        save_checkpoint(path, model, step=step, loss=loss, optimizer=optimizer,
                        scheduler=scheduler, plateau=plateau)
        logger.info(f"checkpoint saved: {path}")

    logger.info(f"training on {device}, per-step segments: "
                f"{cfg.BUCKETS.SEGMENTS_PER_STEP}")
    result = train_segments(
        model, dataset, solver=cfg.SOLVER, max_iter=cfg.SOLVER.MAX_ITER,
        device=device, buckets=cfg.BUCKETS.NUM_TRACKLETS,
        batch_size=cfg.BUCKETS.SEGMENTS_PER_STEP, seed=cfg.ETC.RANDOM_SEED,
        num_objects=cfg.PREDICT.OBJECT_NUM, feature_dim=effective_feature_dim(cfg),
        resume=restored, save=save, save_freq=cfg.ETC.SAVE_FREQ,
        display_freq=cfg.ETC.DISPLAY_FREQ, logger=logger,
    )
    os.makedirs("configs", exist_ok=True)
    cfg.dump_to_file(os.path.join("configs", f"{name}_config.yaml"))
    logger.info("Training Finished Successfully.")
    return result
