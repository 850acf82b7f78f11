"""Detector training (counterpart of tspn_tpu/detection/train.py).

The reference recipe's operating point (IMS_PER_BATCH 4, BASE_LR 2.5e-4,
MAX_ITER 100k, ROI batch 128, 35 classes) driving the port's FasterRCNN
(R-C4, or X101-FPN for an ``FPNConfig``) with SGD and momentum on one device, in float32 or, with
``DetectorTrainConfig.mixed_precision``, in bfloat16 compute over float32
parameters. Batches come from the letterbox or the ResizeShortestEdge
policy (``detection/inputs.py``), grouped by orientation bucket.

On the card RoIAlign runs as K7 forward and K7's backward
(``ops/roi_align.py``); on the CPU autograd differentiates the plain
gather form (JAX on the CPU trains through ``roi_align_xla``).

The loop keeps the JAX trainer's shape: a producer thread assembles
batches into a queue of depth 2, loss readbacks wait for log boundaries,
an optional evaluation hook tracks the best held-out mAP, and the final
checkpoint (parameters, SGD momentum, LR schedule, step) has a
parameters-only ``_best`` sibling. Under a profiler the batch's copy, the
backward pass, the optimizer step and the loop's wait for a batch are the
spans ``tspn.h2d``, ``tspn.backward``, ``tspn.optimizer`` and
``tspn.input_wait`` (``runtime/spans.py``).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tspn_tpu_torch.detection.inputs import (
    DetectorTrainConfig,
    group_by_orientation,
    make_batch,
)
from tspn_tpu_torch.detection.rcnn import FasterRCNN
from tspn_tpu_torch.runtime.logging_utils import MetricLogger, setup_logger
from tspn_tpu_torch.runtime.spans import span

LOSS_KEYS = ("loss_rpn_obj", "loss_rpn_box", "loss_cls", "loss_box")


def build_detector(cfg, generator: torch.Generator | None = None,
                   dtype: torch.dtype = torch.float32) -> FasterRCNN:
    """The detector a config describes: Faster R-CNN X101-FPN for an
    ``FPNConfig``, R-C4 for a ``DetectionConfig``."""
    from tspn_tpu_torch.detection.fpn import FPNConfig, FPNFasterRCNN

    cls = FPNFasterRCNN if isinstance(cfg, FPNConfig) else FasterRCNN
    return cls(cfg, generator=generator, dtype=dtype)


def learning_rate(step: int, cfg: DetectorTrainConfig) -> float:
    """optax.join_schedules([linear_schedule(base/3, base, warmup),
    constant_schedule(base)], [warmup]) at update ``step`` (from 0)."""
    if step < cfg.warmup_iters:
        frac = 1.0 - step / cfg.warmup_iters
        return (cfg.base_lr / 3 - cfg.base_lr) * frac + cfg.base_lr
    return cfg.base_lr


def build_detector_optimizer(parameters, cfg: DetectorTrainConfig):
    """SGD with momentum and weight decay on every parameter (FrozenAffine's
    scale and bias included) and the warm-up schedule -> (optimizer,
    scheduler). In exact arithmetic this is the JAX chain
    add_decayed_weights -> trace(momentum) -> scale_by_schedule -> scale(-1):
    m = g + wd p + momentum m; p -= lr_t m. Step the scheduler once per
    update."""
    optimizer = torch.optim.SGD(parameters, lr=cfg.base_lr, momentum=cfg.momentum,
                                weight_decay=cfg.weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: learning_rate(step, cfg) / cfg.base_lr)
    return optimizer, scheduler


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    with span("tspn.h2d"):
        return {
            "image": torch.as_tensor(batch["image"], dtype=torch.float32).to(device),
            "gt_boxes": torch.as_tensor(batch["gt_boxes"], dtype=torch.float32).to(device),
            "gt_classes": torch.as_tensor(batch["gt_classes"], dtype=torch.int64).to(device),
            "gt_mask": torch.as_tensor(batch["gt_mask"], dtype=torch.float32).to(device),
        }


def detector_train_step(model: FasterRCNN, optimizer, scheduler,
                        batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One update on a device batch -> the four losses and their sum
    ``loss`` (detached, on the device: reading them back is the caller's
    choice)."""
    losses = model(batch["image"], batch["gt_boxes"], batch["gt_classes"], batch["gt_mask"])
    total = sum(losses[k] for k in LOSS_KEYS)
    optimizer.zero_grad(set_to_none=True)
    with span("tspn.backward"):
        total.backward()
    with span("tspn.optimizer"):
        optimizer.step()
        scheduler.step()
    out = {k: v.detach() for k, v in losses.items()}
    out["loss"] = total.detach()
    return out


def _read_back(entry: Dict[str, torch.Tensor]) -> Dict[str, float]:
    keys = list(entry)
    return dict(zip(keys, torch.stack([entry[k].float() for k in keys]).tolist()))


def train_detector(
    records: List[dict],
    det_cfg,
    train_cfg: DetectorTrainConfig,
    seed: int = 0,
    logger=None,
    device="cuda",
    checkpoint_path: Optional[str] = None,
    eval_records: Optional[List[dict]] = None,
    roi_pool=None,
):
    """Train from a seeded init -> (model, history). ``det_cfg`` is a
    ``DetectionConfig`` (R-C4) or an ``FPNConfig`` (X101-FPN,
    ``build_detector``).

    ``history`` holds every step's losses (read back at log boundaries),
    the host seconds between consecutive steps (``step_seconds``: away from
    a log boundary this times the step's enqueue, since only a boundary's
    readback waits for the device), the host seconds each step waited for
    its batch (``input_wait_s``, part of ``step_seconds``) and the
    evaluations.
    With eval_records and ``train_cfg.eval_every > 0`` the evaluation hook
    logs held-out mAP and, with ``keep_best``, the model returned holds
    the best-mAP parameters. The batch order is the JAX trainer's for the
    same seed (one RandomState drives the producer). ``roi_pool`` replaces
    the RoI head's RoIAlign (see ``FasterRCNN``)."""
    from tspn_tpu_torch.detection.eval import run_detector_eval
    from tspn_tpu_torch.runtime.checkpoint import save_checkpoint

    if logger is None:
        logger = setup_logger("detector_train", save_dir="logs")
    device = torch.device(device)
    dtype = torch.bfloat16 if train_cfg.mixed_precision else torch.float32
    model = build_detector(det_cfg, generator=torch.Generator().manual_seed(seed), dtype=dtype)
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    if roi_pool is not None:
        model.roi_pool = roi_pool
    model.train()
    optimizer, scheduler = build_detector_optimizer(model.parameters(), train_cfg)

    rng = np.random.RandomState(seed)
    groups = group_by_orientation(records, train_cfg)
    weights = np.asarray([len(g) for g in groups], np.float64)
    weights /= weights.sum()

    do_eval = bool(eval_records) and train_cfg.eval_every > 0
    best_map, best_iter, best_params = -1.0, 0, None
    history = {"losses": [], "step_seconds": [], "input_wait_s": [], "eval": []}

    # batch assembly (image decode, resize) on a producer thread, two
    # batches ahead; an error there is raised in the loop
    batch_q: queue.Queue = queue.Queue(maxsize=2)

    def producer():
        try:
            for _ in range(train_cfg.max_iter):
                group = groups[rng.choice(len(groups), p=weights)]
                idx = group[rng.choice(len(group), size=train_cfg.ims_per_batch,
                                       replace=True)]
                batch_q.put(make_batch([records[i] for i in idx], train_cfg))
        except BaseException as exc:  # handed to the loop, which raises it
            batch_q.put(exc)

    threading.Thread(target=producer, daemon=True).start()

    meters = MetricLogger()
    pending: list = []
    end = time.time()
    for it in range(train_cfg.max_iter):
        with span("tspn.input_wait"):
            batch = batch_q.get()
        wait_s = time.time() - end
        if isinstance(batch, BaseException):
            raise RuntimeError("detector batch assembly failed") from batch
        losses = detector_train_step(model, optimizer, scheduler,
                                     batch_to_device(batch, device))
        pending.append(losses)
        if it % train_cfg.log_every == 0 or it == train_cfg.max_iter - 1:
            for entry in pending:
                values = _read_back(entry)
                history["losses"].append(values)
                meters.update(**values)
            pending.clear()
        step_s = time.time() - end
        history["step_seconds"].append(step_s)
        history["input_wait_s"].append(wait_s)
        meters.update(time=step_s, wait=wait_s)
        if it % train_cfg.log_every == 0:
            logger.info(f"[{it + 1}/{train_cfg.max_iter}]  {meters}")
        if do_eval and (it + 1) % train_cfg.eval_every == 0:
            mean_ap, _per_class = run_detector_eval(model, eval_records, device=device,
                                                    train_cfg=train_cfg)
            history["eval"].append((it + 1, mean_ap))
            if train_cfg.keep_best and mean_ap > best_map:
                best_map, best_iter = mean_ap, it + 1
                best_params = {k: v.detach().to("cpu", copy=True)
                               for k, v in model.state_dict().items()}
            logger.info(f"[eval @ {it + 1}] mAP = {mean_ap:.4f} (best {best_map:.4f})")
        end = time.time()  # eval time is not step time

    if checkpoint_path:
        # the main checkpoint is the FINAL (parameters, optimizer, schedule,
        # step); the best-mAP parameters go to a sibling stamped with their
        # own iteration
        save_checkpoint(checkpoint_path, model, step=train_cfg.max_iter,
                        optimizer=optimizer, scheduler=scheduler)
        logger.info(f"detector checkpoint saved: {checkpoint_path}")
        if do_eval and train_cfg.keep_best and best_params is not None:
            root, ext = os.path.splitext(checkpoint_path)
            best_path = f"{root}_best{ext}"
            save_checkpoint(best_path, best_params, step=best_iter)
            logger.info(f"best-mAP checkpoint saved: {best_path} "
                        f"(mAP {best_map:.4f} @ iter {best_iter})")

    if do_eval and train_cfg.keep_best and best_params is not None:
        logger.info(f"returning best-mAP params (mAP {best_map:.4f})")
        model.load_state_dict(best_params)
    return model, history


def launch(main_fn, num_machines: int = 1, machine_rank: int = 0,
           dist_url: Optional[str] = None, args: tuple = ()):
    """The reference's detectron2 ``launch`` contract for one machine: a
    plain call. Several machines are not ported yet (ROADMAP queue 1,
    multi-GPU)."""
    del machine_rank, dist_url
    if num_machines > 1:
        raise NotImplementedError(
            "multi-machine detector training is not ported (ROADMAP queue 1, "
            "multi-GPU); run one machine"
        )
    return main_fn(*args)
