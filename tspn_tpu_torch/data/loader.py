"""Batching of segments into fixed-shape numpy buffers.

Numpy copy of the JAX package's batching: ``SegmentRecord``
(tspn_tpu/data/vrdataset.py:47-70), ``batch_buffers`` and ``fill_padded``
(vrdataset.py:246-326), and the bucket grouping of ``BucketedLoader``
(tspn_tpu/data/loader.py:35-210) for both of its uses: one unshuffled
pass for inference, and the training stream (epoch-seeded shuffle,
``max_iter`` batches across epochs, ``skip_batches`` for resume, and the
end-of-epoch flush padded by repetition). Those modules import h5py at
their top. ``tests/test_torch_predict.py`` and
``tests/test_torch_train.py`` hold this loader's batches equal, key by
key, to the JAX BucketedLoader's. As there, a producer thread assembles
up to ``prefetch`` batches ahead of the consumer (``prefetch=0``
assembles each batch when the consumer asks for it).

For a CUDA ``device`` the leaves are pinned host tensors
(``pin_memory=True``), so that their copies to the card can run
asynchronously (``leaf_to_device(..., non_blocking=True)``). PyTorch's
pinned-memory cache is their ring: a batch's tensors go back to it when
the batch is dropped, and it hands a block out again only after the
copies that read it, which it records, have completed. On the CPU the
leaves are numpy arrays and nothing is pinned.

Float feature leaves are f32 numpy arrays, or, for a model that computes
in bf16 (``feats_dtype=torch.bfloat16``, the JAX loader's
``ml_dtypes.bfloat16`` leaves), a bf16 CPU tensor: each record's f32 rows
are cast into it by round-to-nearest-even as they are copied, which is
what writing f32 rows into an ``ml_dtypes.bfloat16`` buffer does, bit for
bit. So half the bytes cross to the card. ``leaf_to_device`` moves
either kind.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

SegmentIndex = Tuple[str, int, int]


@dataclass
class SegmentRecord:
    """One segment's proposal-pair features (ragged, host)."""

    index: SegmentIndex
    feats: np.ndarray       # (P, D) f32 with L1-normalized BoW blocks, or
    #                         int8 rows when q8_scales is set
    pairs: np.ndarray       # (P, 2) int64 proposal tracklet indices
    labels: Optional[np.ndarray]  # (P, num_predicates) f32 multi-hot; None
    #                               at inference
    cls_logits: np.ndarray  # (N, num_objects) f32 per-tracklet classeme
    num_proposals: int      # N
    iou: np.ndarray         # (N+GT, N+GT) f32, passed through to the output
    trackid: np.ndarray     # (N+GT,) int64
    # q8: (P, 16) row multipliers (ops/pairwise.precompute_q8_scales);
    # q8f: the relative rows' scales, with feats the (P, rel_pad) rows
    q8_scales: Optional[np.ndarray] = None
    # q8f: per-tracklet int8 descriptors + scales
    trk_feats: Optional[np.ndarray] = None
    trk_scales: Optional[np.ndarray] = None


def pick_bucket(num_tracklets: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= num_tracklets (the largest if none fits; the
    record is then truncated to that capacity)."""
    for b in sorted(buckets):
        if num_tracklets <= b:
            return b
    return max(buckets)


def _zeros(shape, dtype, pin: bool):
    """A zeroed leaf: a numpy array, or with ``pin`` a pinned CPU tensor."""
    if not pin:
        return np.zeros(shape, dtype)
    return torch.zeros(shape, dtype=torch.from_numpy(np.zeros(0, dtype)).dtype,
                       pin_memory=True)


def batch_buffers(
    template, batch_size: int, n_bucket: int, num_objects: int, feature_dim: int,
    feats_dtype=torch.float32, pin: bool = False,
) -> Dict[str, np.ndarray]:
    """Zeroed batch leaves (P_max = n_bucket * (n_bucket - 1)):
    feats (B, P_max, D), int8 for q8 and q8f records, else f32 (or, with
    ``feats_dtype`` bf16, a bf16 tensor);
    pairs (B, P_max, 2) int32, padding points at tracklet 0;
    labels (B, P_max, R) f32 when the template carries labels;
    pair_mask (B, P_max); cls_logits (B, n_bucket, C); track_mask
    (B, n_bucket); feat_scale (B, P_max, 16) for q8 and q8f records;
    trk_feats / trk_scales for q8f records. With ``pin`` every leaf is a
    pinned CPU tensor of that dtype."""
    p_max = n_bucket * (n_bucket - 1)
    shape = (batch_size, p_max, feature_dim)
    if template.q8_scales is not None:
        feats = _zeros(shape, np.int8, pin)
    elif feats_dtype == torch.bfloat16:
        feats = (torch.zeros(shape, dtype=torch.bfloat16, pin_memory=True) if pin
                 # numpy's zeroed pages seen as bf16
                 else torch.from_numpy(np.zeros(shape, np.int16)).view(torch.bfloat16))
    else:
        feats = _zeros(shape, np.float32, pin)
    bufs = {
        "feats": feats,
        "pairs": _zeros((batch_size, p_max, 2), np.int32, pin),
        "pair_mask": _zeros((batch_size, p_max), np.float32, pin),
        "cls_logits": _zeros((batch_size, n_bucket, num_objects), np.float32, pin),
        "track_mask": _zeros((batch_size, n_bucket), np.float32, pin),
    }
    if template.labels is not None:
        bufs["labels"] = _zeros((batch_size, p_max, template.labels.shape[1]), np.float32, pin)
    if template.q8_scales is not None:
        bufs["feat_scale"] = _zeros((batch_size, p_max, 16), np.float32, pin)
    if template.trk_feats is not None:
        bufs["trk_feats"] = _zeros((batch_size, n_bucket, template.trk_feats.shape[1]),
                                   np.int8, pin)
        bufs["trk_scales"] = _zeros((batch_size, n_bucket, 16), np.float32, pin)
    return bufs


def leaf_to_device(leaf, device, non_blocking: bool = False) -> torch.Tensor:
    """A batch leaf (numpy array or CPU tensor) as a tensor on ``device``;
    ``non_blocking`` copies a pinned leaf asynchronously on the current
    stream."""
    return torch.as_tensor(leaf).to(device, non_blocking=non_blocking)


def host_array(leaf):
    """A leaf as numpy: a pinned leaf's numpy view, a numpy leaf itself (a
    bf16 leaf stays a tensor: numpy has no bf16)."""
    if isinstance(leaf, torch.Tensor) and leaf.dtype != torch.bfloat16:
        return leaf.numpy()
    return leaf


def fill_padded(bufs: Dict[str, np.ndarray], b: int, record, n_bucket: int) -> None:
    """Write one record into batch slot ``b``; pairs that reach past the
    bucket's capacity are dropped."""
    bufs = {k: host_array(v) for k, v in bufs.items()}
    n = min(record.num_proposals, n_bucket)
    p_max = n_bucket * (n_bucket - 1)
    keep = (record.pairs[:, 0] < n) & (record.pairs[:, 1] < n)
    if keep.all():
        feats_src, pairs_src = record.feats, record.pairs
        labels_src, scales_src = record.labels, record.q8_scales
    else:
        feats_src = record.feats[keep]
        pairs_src = record.pairs[keep]
        labels_src = None if record.labels is None else record.labels[keep]
        scales_src = None if record.q8_scales is None else record.q8_scales[keep]
    p = min(feats_src.shape[0], p_max)
    if isinstance(bufs["feats"], torch.Tensor):  # cast by RNE as it copies
        bufs["feats"][b, :p].copy_(torch.from_numpy(np.ascontiguousarray(feats_src[:p])))
    else:
        bufs["feats"][b, :p] = feats_src[:p]
    bufs["pairs"][b, :p] = pairs_src[:p]
    bufs["pair_mask"][b, :p] = 1.0
    if "labels" in bufs:
        bufs["labels"][b, :p] = labels_src[:p]
    m = min(record.cls_logits.shape[0], n)
    bufs["cls_logits"][b, :m] = record.cls_logits[:m]
    bufs["track_mask"][b, :n] = 1.0
    if "feat_scale" in bufs:
        bufs["feat_scale"][b, :p] = scales_src[:p]
    if "trk_feats" in bufs:
        bufs["trk_feats"][b, :n] = record.trk_feats[:n]
        bufs["trk_scales"][b, :n] = record.trk_scales[:n]


class BucketedLoader:
    """Segments grouped by tracklet bucket; yields (bucket, batch,
    indices, records). A bucket's batch is emitted when it fills; at the
    end of an epoch the leftovers are flushed, padded by repeating their
    segments so every batch has ``batch_size`` rows.

    With ``max_iter`` None it makes one pass in index order (inference).
    Otherwise it yields batches ``skip_batches .. max_iter - 1`` of an
    endless stream of epochs; with ``shuffle`` epoch e visits the
    segments in ``RandomState(seed + e).permutation(n)`` order. Skipped
    batches are drawn but not assembled, so a resumed run continues at
    its checkpoint's position. ``include_labels`` loads each record's
    multi-hot labels into a ``labels`` leaf.

    ``dataset`` needs ``__len__``, ``num_proposals_of(i)`` and
    ``load_segment(i, with_labels)``. ``feats_dtype`` torch.bfloat16 turns
    a float ``feats`` leaf into bf16 (int8 leaves stay int8).

    ``prefetch`` > 0 assembles batches on a producer thread, at most that
    many ahead: an exception there is raised in the consumer, and a
    consumer that stops early stops the thread. A CUDA ``device`` makes
    the leaves pinned tensors (see the module docstring).
    """

    def __init__(
        self, dataset, buckets: Sequence[int], batch_size: int,
        feature_dim: int, num_objects: int, *, max_iter: Optional[int] = None,
        shuffle: bool = False, seed: int = 0, skip_batches: int = 0,
        include_labels: bool = False, feats_dtype=torch.float32,
        prefetch: int = 2, device=None,
    ):
        if feats_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"feature leaves in {feats_dtype}: float32 or bfloat16")
        self.feats_dtype = feats_dtype
        self.dataset = dataset
        self.buckets = sorted(buckets)
        self.batch_size = batch_size
        self.feature_dim = feature_dim
        self.num_objects = num_objects
        self.max_iter = max_iter
        self.shuffle = shuffle
        self.seed = seed
        self.skip_batches = int(skip_batches)
        self.include_labels = include_labels
        self.prefetch = int(prefetch)
        self.pin = device is not None and torch.device(device).type == "cuda"
        self._bucket_of = [
            pick_bucket(dataset.num_proposals_of(i), self.buckets)
            for i in range(len(dataset))
        ]

    def __len__(self) -> int:
        """Number of batches an iteration yields."""
        if self.max_iter is not None:
            return max(self.max_iter - self.skip_batches, 0)
        counts = np.bincount(self._bucket_of, minlength=max(self.buckets) + 1)
        return int(sum(-(-counts[b] // self.batch_size) for b in self.buckets))

    def _epoch_order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.RandomState(self.seed + epoch).permutation(n)
        return np.arange(n)

    def _groups(self) -> Iterator[Tuple[int, List[int]]]:
        """(bucket, indices) groups: one epoch, or endless with max_iter."""
        epoch = 0
        while True:
            pending: Dict[int, List[int]] = {b: [] for b in self.buckets}
            for i in self._epoch_order(epoch):
                b = self._bucket_of[i]
                pending[b].append(int(i))
                if len(pending[b]) == self.batch_size:
                    yield b, pending[b]
                    pending[b] = []
            for b, idxs in pending.items():
                if idxs:
                    yield b, (idxs * self.batch_size)[: self.batch_size]
            epoch += 1
            if self.max_iter is None:
                return

    def _items(self) -> Iterator[Tuple[int, List[int]]]:
        """The (bucket, indices) of the batches an iteration yields: the
        skipped ones drawn but not assembled, then up to ``max_iter``."""
        groups = self._groups()
        for _ in range(self.skip_batches):
            if next(groups, None) is None:
                return
        for count, item in enumerate(groups, start=self.skip_batches):
            if self.max_iter is not None and count >= self.max_iter:
                return
            yield item

    def _assemble(self, bucket: int, idxs: List[int]) -> tuple:
        records = [
            self.dataset.load_segment(i, with_labels=self.include_labels)
            for i in idxs
        ]
        bufs = batch_buffers(
            records[0], len(records), bucket, self.num_objects, self.feature_dim,
            self.feats_dtype, self.pin,
        )
        for b, r in enumerate(records):
            fill_padded(bufs, b, r, bucket)
        return bucket, bufs, [r.index for r in records], records

    def __iter__(self):
        if self.prefetch <= 0:
            for bucket, idxs in self._items():
                yield self._assemble(bucket, idxs)
            return
        # the JAX loader's producer (tspn_tpu/data/loader.py:153-209): a
        # bounded queue, a stop event, errors re-raised in the consumer
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            # never block for good: a consumer that stopped early leaves
            # the queue full and only sets `stop`
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for bucket, idxs in self._items():
                    if stop.is_set() or not put(self._assemble(bucket, idxs)):
                        return
            except BaseException as exc:  # surfaces in the consumer
                put(_Failure(exc))
                return
            put(done)

        threading.Thread(target=producer, name="BucketedLoader-prefetch", daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, _Failure):
                    raise item.exc
                yield item
        finally:
            stop.set()


@dataclass
class _Failure:
    """An exception of the producer thread, on its way to the consumer."""

    exc: BaseException
