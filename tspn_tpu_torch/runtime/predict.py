"""Short-term relation prediction over test segments (segment mode).

Counterpart of tspn_tpu/runtime/predict.py without the device mesh. Per
segment batch: score every pair, take a two-stage top-k on the device
(top TOPK_PER_PAIR predicates per pair, then top TOPK_PER_SEG (pair,
predicate) entries per segment), read the selection back, and assemble
triplets on the host. Three scorers, picked by the dataset:

* q8f (factored int8 store): ``factored_classify_q8_fused``, one q8s
  launch (tracklet pass) and one q8f_fused launch (rel pass with the
  A-table add) per batch;
* q8 (expanded int8 rows): one q8s kernel launch per batch;
* f32 (per-file or f32 store): the model itself, its nn.Linear or, for
  a fused-classifier model built with ``inference=True``, one launch of
  the fused_classify kernel per batch over raw device-layout rows. A
  model that computes in bf16 (MODEL.DTYPE) gets bf16 rows from the
  loader: its Linear runs in bf16, and the fused classifier launches K3's
  bf16 half (fused_classify_bf16) instead. The PPN head computes in the
  model's dtype with every scorer.

PPN pruning (``num_pair_proposals`` > 0, a model with the PPN head; the
config's RELPN.USE_PPN and PPN.PRUNE_AT_INFERENCE): the head scores every
pair row from the classeme logits, rows with ``pair_mask == 0`` get
-inf, and only the top min(K, P) rows of each segment are scored, by the
same scorer and the same launches; with FUSE_SCORE the relation
probabilities are multiplied by the pair's PPN probability. The top-k
then takes the finite rows only and maps its pair indices back through
the selected rows.

The loop is pipelined as the JAX package's: ``infer.dispatch`` queues a
batch's work on the card and returns at once, and its readback waits until
``pipeline_depth`` more batches are in flight, so batch i's triplets are
assembled on the host while batch i + 1 is on the card (depth 0 reads each
batch back before the next is assembled). On the card the loader fills
pinned host buffers, the host-to-device copies run on a copy stream that
the compute stream waits for by an event, and the top-k selection comes
back into pinned buffers, completed by an event. On the CPU the same code
runs synchronously.

Output contract, as in the JAX package: {(vid, fstart, fend):
(predictions, iou, trackid)} with predictions = [(score, (s_cls, pred,
o_cls), (s_tid, o_tid)), ...].
"""

from __future__ import annotations

import os
from collections import deque
from typing import Callable, Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from tspn_tpu_torch.data.layout import FeatureLayout
from tspn_tpu_torch.data.loader import BucketedLoader, host_array, leaf_to_device
from tspn_tpu_torch.ops import pairwise as pw

def select_topk(
    rel_prob: torch.Tensor,   # (B, P, R)
    pair_mask: torch.Tensor,  # (B, P)
    topk_per_pair: int,
    topk_per_seg: int,
):
    """Batched two-stage top-k -> (scores, pair_idx, pred_idx, valid),
    each (B, K). Masked pairs score -inf, so ``valid`` marks the finite
    selections and invalid scores read 0. Scores come back in f32 (a bf16
    model's bf16 probabilities widened exactly)."""
    bsz, p, r = rel_prob.shape
    k1 = min(topk_per_pair, r)
    per_pair_scores, per_pair_preds = torch.topk(rel_prob, k1, dim=-1)
    masked = torch.where(
        pair_mask[..., None] > 0, per_pair_scores,
        torch.full_like(per_pair_scores, -float("inf")),
    )
    k2 = min(topk_per_seg, p * k1)
    flat_scores, flat_idx = torch.topk(masked.reshape(bsz, -1), k2, dim=-1)
    pair_idx = torch.div(flat_idx, k1, rounding_mode="floor")
    pred_idx = torch.gather(per_pair_preds.reshape(bsz, -1), 1, flat_idx)
    valid = torch.isfinite(flat_scores)
    return (
        torch.where(valid, flat_scores, torch.zeros_like(flat_scores)).float(),
        pair_idx.to(torch.int32),
        pred_idx.to(torch.int32),
        valid,
    )


def classifier_weights(model) -> Tuple[np.ndarray, np.ndarray]:
    """(W (dim, R), b (R,)) float32 numpy in the storage layout, from the
    model's nn.Linear or, for a fused classifier, from its device-layout
    kernel through the inverse permutation; so the int8 scorers serve a
    model trained either way."""
    cls = model.classifier
    if cls.fused:
        w_dev = cls.kernel.detach().to("cpu", torch.float32).numpy()
        b = cls.bias.detach().to("cpu", torch.float32).numpy()
        return pw.weights_from_device_layout(w_dev, cls.layout), b.copy()
    lin = cls.rel_predictor
    w = lin.weight.detach().to("cpu", torch.float32).numpy().T
    b = lin.bias.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(w), b.copy()


def q8_classifier_weights(w: np.ndarray, b: np.ndarray, layout: FeatureLayout,
                          device) -> dict:
    """Expanded-path weights: device-layout, per-column int8, transposed
    once to (R, device_dim) K-major."""
    qw, sw = pw.quantize_weights_percol(pw.weights_to_device_layout(w, layout))
    return {
        "qw_t": torch.from_numpy(np.ascontiguousarray(qw.T)).to(device),
        "sw": torch.from_numpy(sw).to(device),
        "b": torch.from_numpy(np.asarray(b, np.float32)).to(device),
        "layout": layout,
    }


def q8f_classifier_weights(w: np.ndarray, b: np.ndarray, layout: FeatureLayout,
                           device) -> dict:
    """Factored-path weights (split_weights_factored), int8 transposed
    once to K-major."""
    wq = pw.split_weights_factored(w, layout)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {
        "wq": {
            "qw_trk_t": put(wq["qw_trk"].T), "sw_trk": put(wq["sw_trk"]),
            "qw_rel_t": put(wq["qw_rel"].T), "sw_rel": put(wq["sw_rel"]),
        },
        "b": put(np.asarray(b, np.float32)),
        "layout": layout,
    }


def take_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(B, P, ...) x, (B, K) row indices -> (B, K, ...) selected rows."""
    idx = rows.reshape(*rows.shape, *([1] * (x.dim() - 2)))
    return torch.gather(x, 1, idx.expand(*rows.shape, *x.shape[2:]))


def make_q8f_scorer(weights: dict, plain: bool = False) -> Callable:
    """Factored scorer; ``score(batch, rows)`` scores only the rel rows
    ``rows`` (B, K) of each segment, as the kernel takes arbitrary pair
    lists."""
    wq, b, layout = weights["wq"], weights["b"], weights["layout"]

    def score(batch, rows=None):
        rel_q, scales, pairs = batch["feats"], batch["feat_scale"], batch["pairs"]
        if rows is not None:
            rel_q, scales, pairs = (take_rows(t, rows) for t in (rel_q, scales, pairs))
        return pw.factored_classify_q8_fused(
            batch["trk_feats"], batch["trk_scales"], rel_q, scales, pairs, wq, b,
            layout=layout, plain=plain,
        )

    return score


def make_q8_scorer(weights: dict, plain: bool = False) -> Callable:
    geom = weights["layout"]
    q8s = pw.normalize_classify_q8s_plain if plain else pw.normalize_classify_q8s

    def score(batch, rows=None):
        feats, scales = batch["feats"], batch["feat_scale"]
        if rows is not None:
            feats, scales = take_rows(feats, rows), take_rows(scales, rows)
        lead = feats.shape[:-1]
        out = q8s(
            feats.reshape(-1, feats.shape[-1]), scales.reshape(-1, 16),
            weights["qw_t"], weights["sw"], weights["b"], geom,
        )
        return out.reshape(*lead, out.shape[-1])

    return score


def make_f32_scorer(model, plain: bool = False) -> Callable:
    def score(batch, rows=None):
        feats = batch["feats"] if rows is None else take_rows(batch["feats"], rows)
        return model.classifier(feats, plain=plain)

    return score


def rank_pairs(pair_logits: torch.Tensor, pairs: torch.Tensor,
               pair_mask: torch.Tensor, num_pair_proposals: int):
    """PPN pruning: (B, N, N) pair logits, (B, P, 2) pairs, (B, P) mask ->
    (top_rows (B, K), keep (B, K) f32, sigmoid of the top logits (B, K))
    with K = min(num_pair_proposals, P); masked rows score -inf, and
    ``keep`` is 0 exactly where a selected row's logit is not finite."""
    bsz, n, _ = pair_logits.shape
    flat = pairs[..., 0].long() * n + pairs[..., 1].long()
    row_logits = torch.gather(pair_logits.reshape(bsz, n * n), 1, flat)
    masked = torch.where(pair_mask > 0, row_logits,
                         torch.full_like(row_logits, -float("inf")))
    k = min(num_pair_proposals, masked.shape[1])
    top_logits, top_rows = torch.topk(masked, k, dim=-1)
    keep = torch.isfinite(top_logits).to(torch.float32)
    return top_rows, keep, torch.sigmoid(top_logits)


def prune_settings(cfg) -> Tuple[int, bool]:
    """(num_pair_proposals, fuse_ppn_score) from the config: pruning is
    on under RELPN.USE_PPN and RELPN.PPN.PRUNE_AT_INFERENCE."""
    ppn = cfg.RELPN.PPN
    prune = bool(cfg.RELPN.USE_PPN) and bool(ppn.get("PRUNE_AT_INFERENCE", False))
    return (int(ppn.NUM_PAIR_PROPOSALS) if prune else 0,
            bool(ppn.get("FUSE_SCORE", False)))


# batch leaves each scorer reads; nothing else is copied to the device
_KEYS = {
    "q8f": ("trk_feats", "trk_scales", "feats", "feat_scale", "pairs", "pair_mask"),
    "q8": ("feats", "feat_scale", "pair_mask"),
    "f32": ("feats", "pair_mask"),
}
# and what the PPN-pruned path reads besides
_PRUNE_KEYS = ("cls_logits", "pairs")


def dataset_mode(dataset) -> str:
    if getattr(dataset, "factored", False):
        return "q8f"
    if getattr(dataset, "quantized", False):
        return "q8"
    return "f32"


class Infer:
    """Batched inference split in two halves: ``dispatch(batch)`` queues a
    batch's copies and scoring and returns a handle, ``readback(handle)``
    waits for it -> (scores, pair_idx, pred_idx, valid) numpy arrays, each
    (B, K). On a CUDA device the copies run on
    a copy stream, ordered to the compute stream by an event, and the
    results come back into pinned buffers, completed by an event; on the
    CPU ``dispatch`` computes the results."""

    def __init__(self, compute: Callable, keys: tuple, device: torch.device):
        self.compute, self.keys, self.device = compute, keys, device
        self.copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    @torch.no_grad()
    def dispatch(self, batch):
        if self.copy_stream is None:
            dev = {k: leaf_to_device(batch[k], self.device) for k in self.keys}
            return tuple(t.numpy() for t in self.compute(dev))
        stream = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.copy_stream):
            dev = {k: leaf_to_device(batch[k], self.device, non_blocking=True)
                   for k in self.keys}
        stream.wait_stream(self.copy_stream)
        for t in dev.values():  # allocated on the copy stream, used on this one
            t.record_stream(stream)
        outs = self.compute(dev)
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in outs)
        for h, t in zip(host, outs):
            h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
        return host, done

    def readback(self, handle):
        if self.copy_stream is None:
            return handle
        host, done = handle
        done.synchronize()
        return tuple(h.numpy() for h in host)


def build_infer(model, mode: str, layout: FeatureLayout, topk_per_pair: int,
                topk_per_seg: int, device, plain: bool = False,
                num_pair_proposals: int = 0, fuse_ppn_score: bool = False) -> Infer:
    """-> an ``Infer`` over batches of host leaves: the scorer of ``mode``
    and the two-stage top-k. ``plain=True`` scores with the plain PyTorch
    version of every kernel, on any device. ``num_pair_proposals`` > 0
    prunes with the model's PPN head (see the module docstring)."""
    device = torch.device(device)
    if num_pair_proposals > 0 and not getattr(model, "use_ppn", False):
        raise ValueError("PPN pruning needs a model built with the PPN head")
    if mode == "f32":
        score = make_f32_scorer(model, plain)
    else:
        w, b = classifier_weights(model)
        if mode == "q8f":
            score = make_q8f_scorer(q8f_classifier_weights(w, b, layout, device), plain)
        else:
            score = make_q8_scorer(q8_classifier_weights(w, b, layout, device), plain)
    keys = _KEYS[mode]
    if num_pair_proposals > 0:
        keys = tuple(dict.fromkeys(keys + _PRUNE_KEYS))

    def compute(dev):
        if num_pair_proposals <= 0:
            rel_prob = torch.sigmoid(score(dev))
            return select_topk(rel_prob, dev["pair_mask"], topk_per_pair, topk_per_seg)
        pair_logits = model.ppn_head(dev["cls_logits"])
        top_rows, keep, ppn_scores = rank_pairs(
            pair_logits, dev["pairs"], dev["pair_mask"], num_pair_proposals
        )
        rel_prob = torch.sigmoid(score(dev, top_rows))
        if fuse_ppn_score:
            rel_prob = rel_prob * ppn_scores[..., None]
        scores, pair_idx, pred_idx, valid = select_topk(
            rel_prob, keep, topk_per_pair, topk_per_seg
        )
        pair_idx = torch.gather(top_rows, 1, pair_idx.long()).to(torch.int32)
        return scores, pair_idx, pred_idx, valid

    return Infer(compute, keys, device)


class _PendingSeg(NamedTuple):
    """The fields of a segment that the readback reads: holding these, not
    whole records, keeps in-flight batches from retaining feature rows."""

    num_proposals: int
    cls_logits: np.ndarray
    iou: np.ndarray
    trackid: np.ndarray


def predict_segments(
    model, dataset, *, device, buckets: Sequence[int] = (8, 16, 24, 32),
    batch_size: int = 1, topk_per_pair: int = 20, topk_per_seg: int = 200,
    num_objects: int = 35, feature_dim: int = None, logger=None,
    plain: bool = False, num_pair_proposals: int = 0,
    fuse_ppn_score: bool = False, batch_hook: Callable = None,
    pipeline_depth: int = 2,
) -> Dict[Tuple[str, int, int], tuple]:
    """Relation prediction over every segment of ``dataset`` (a per-file
    SegmentDataset, a consolidated store, or in-memory records); the
    store's mode (q8f, q8, f32) picks the scorer. The f32 scorer and the
    PPN head run ``model`` itself, which must then be on ``device``; the
    int8 scorers quantize its weights onto ``device``.
    ``num_pair_proposals`` > 0 scores only each segment's top PPN pairs.
    ``batch_hook(batch) -> batch`` runs on each batch before its dispatch.
    ``pipeline_depth`` bounds how many batches are in flight before a
    blocking readback (0: each batch is read back before the next is
    assembled); every depth gives the same result. Segments with at most
    one proposal yield no entry. -> {(vid, fstart, fend): (predictions,
    iou, trackid)}."""
    mode = dataset_mode(dataset)
    layout = FeatureLayout.for_objects(num_objects)
    if feature_dim is None:
        feature_dim = (
            dataset.feature_width() if hasattr(dataset, "feature_width")
            else layout.dim
        )
    loader = BucketedLoader(
        dataset, buckets=buckets, batch_size=batch_size,
        feature_dim=feature_dim, num_objects=num_objects,
        feats_dtype=getattr(model, "compute_dtype", torch.float32), device=device,
    )
    infer = build_infer(model, mode, layout, topk_per_pair, topk_per_seg,
                        device, plain=plain, num_pair_proposals=num_pair_proposals,
                        fuse_ppn_score=fuse_ppn_score)

    short_term_relations: Dict[Tuple[str, int, int], tuple] = {}
    seen = set()

    def drain(entry):
        handle, indices, records, pairs_b = entry
        scores_b, pair_idx_b, pred_idx_b, valid_b = infer.readback(handle)
        for b, index in enumerate(indices):
            if index in seen:  # end-of-pass padding repeats segments
                continue
            seen.add(index)
            record = records[b]
            if record.num_proposals <= 1:
                if logger:
                    logger.info(f"No relation exists in video segment {index}")
                continue
            cls_logits = record.cls_logits
            obj_labels = (
                np.argmax(cls_logits, axis=1) if cls_logits.size
                else np.zeros(record.num_proposals, np.int64)
            )
            ok = np.asarray(valid_b[b], bool)
            tids = pairs_b[b][pair_idx_b[b][ok]].astype(np.int64)  # (M, 2)
            triplets = np.stack(
                [
                    obj_labels[tids[:, 0]],
                    pred_idx_b[b][ok].astype(np.int64),
                    obj_labels[tids[:, 1]],
                ],
                axis=1,
            )
            predictions = list(zip(scores_b[b][ok].astype(np.float32), triplets, tids))
            short_term_relations[index] = (
                predictions, np.asarray(record.iou), np.asarray(record.trackid)
            )

    pending: deque = deque()
    for _bucket, batch, indices, records in loader:
        if batch_hook is not None:
            batch = batch_hook(batch)
        slim = [_PendingSeg(r.num_proposals, r.cls_logits, r.iou, r.trackid)
                for r in records]
        # the pair ids are copied: the batch's buffers go back to the loader
        pending.append((infer.dispatch(batch), indices, slim,
                        host_array(batch["pairs"]).copy()))
        if len(pending) > pipeline_depth:
            drain(pending.popleft())
    while pending:
        drain(pending.popleft())
    return short_term_relations


def predict(cfg, basedata, device, logger=None):
    """Checkpoint-loading entry point (counterpart of the JAX package's
    ``predict``): reads the test split through the port's dataset readers
    (they import h5py where they read) and scores it on ``device``, PPN-
    pruned when the config asks for it (``prune_settings``)."""
    from tspn_tpu_torch.data.segments import get_model_path
    from tspn_tpu_torch.data.vrdataset import effective_feature_dim
    from tspn_tpu_torch.models.tspn import build_model_from_config
    from tspn_tpu_torch.runtime.checkpoint import load_checkpoint

    phase = basedata.infer_test_split()
    mode = str(cfg.PREDICT.get("CONSOLIDATED", "") or "")
    if mode:
        from tspn_tpu_torch.data.preprocess import (
            ConsolidatedSegmentDataset,
            consolidated_path,
        )

        path = consolidated_path(phase)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"PREDICT.CONSOLIDATED={mode!r} but {path} does not exist; run "
                "base.py --preprocess with the same config first"
            )
        dataset = ConsolidatedSegmentDataset(cfg, path)
        if dataset.store.mode != mode:
            raise ValueError(
                f"PREDICT.CONSOLIDATED={mode!r} but {path} was consolidated "
                f"as {dataset.store.mode!r}"
            )
    else:
        from tspn_tpu_torch.data.vrdataset import SegmentDataset

        dataset = SegmentDataset(cfg, basedata, phase=phase)
    if len(dataset) == 0:
        raise ValueError("no test segments with cached features found")

    model = build_model_from_config(cfg, inference=True)
    num_pair_proposals, fuse_ppn_score = prune_settings(cfg)
    ckpt = os.path.join(get_model_path(), cfg.ETC.MODEL_DUMP_FILE)
    restored = load_checkpoint(ckpt)
    model.load_state_dict(restored["state_dict"])
    model.to(device).eval()
    if logger:
        logger.info(f"=> checkpoint loaded from {ckpt} (iter {restored['step']})")
        logger.info("predicting short-term visual relation...")
    return predict_segments(
        model, dataset, device=device,
        buckets=cfg.BUCKETS.NUM_TRACKLETS,
        batch_size=cfg.DATASET.TEST_BATCH_SIZE,
        topk_per_pair=cfg.PREDICT.TOPK_PER_PAIR,
        topk_per_seg=cfg.PREDICT.TOPK_PER_SEG,
        num_objects=cfg.PREDICT.OBJECT_NUM,
        feature_dim=None if mode else effective_feature_dim(cfg),
        logger=logger, num_pair_proposals=num_pair_proposals,
        fuse_ppn_score=fuse_ppn_score,
    )
