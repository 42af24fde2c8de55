"""Batching pipeline: weighted mixing sampler + threaded prefetch
(counterpart of hcmoco_tpu/data/pipeline.py), and the upload of a host
batch to the model's device (`to_device`).

Behavioral spec: `build_own_contrast_loader` (datasets/util.py:530-597) —
a WeightedRandomSampler (with replacement) balancing the NTU frames against
the auxiliary set (MPII/COCO db, or the Parsing-4K seg frames), feeding a
per-rank DataLoader.

Deltas from the reference: one batch stream (no per-rank loaders /
DistributedSamplerWrapper), and a background thread pool decodes samples
ahead of the device step.  Under data parallelism every rank draws the
same global batch of indices and decodes only its rows of it (`rows`):
the other rows' random draws are consumed without a decode
(`skip_draws`), so the ranks' batches concatenate to the one-process
batch.  The weighting math is identical:
  NTU-vs-db:   w[db]  = ntu_len/total,  w[ntu] = db_len/total
  NTU-vs-seg:  w[ntu] = seg_len/total,  w[seg] = ntu_len/total
(util.py:570-576; note the NTUSeg case flips which side is "first").
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
from typing import Dict, Iterator

import numpy as np
import torch


def mixing_weights(total: int, first_len: int, second_len: int,
                   first_weight_from_second: bool = True) -> np.ndarray:
    """w[:first_len] = second_len/total, w[first_len:] = first_len/total."""
    w = np.zeros(total, np.float64)
    w[:first_len] = second_len / total
    w[first_len:] = first_len / total
    return w


class WeightedBatchSampler:
    """Replacement sampling with per-index weights (WeightedRandomSampler +
    DistributedSamplerWrapper collapsed to the global view)."""

    def __init__(self, weights: np.ndarray, seed: int = 0):
        s = weights.sum()
        self.p = (weights / s) if s > 0 else None
        self.n = len(weights)
        self._rng = np.random.default_rng(seed)

    def draw(self, batch_size: int) -> np.ndarray:
        return self._rng.choice(self.n, size=batch_size, replace=True,
                                p=self.p)


def collate(samples) -> Dict[str, np.ndarray]:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}


class DataSource:
    """Iterable of collated batches with a thread-pool prefetcher.

    rows: the positions in each global batch of `batch_size` that this
    source decodes (a data-parallel rank's, mesh.shard_positions), in
    order; None decodes them all.  Every sample's draws come from its
    dataset's generator in global-batch order, the skipped rows' through
    the dataset's skip_draws, so at num_workers=1 the ranks' batches are
    the rows of the one-process batch (with more workers the shared
    generator makes the draws depend on thread timing, as it does for one
    process)."""

    def __init__(self, dataset, batch_size: int, weights: np.ndarray,
                 seed: int = 0, num_workers: int = 8, prefetch: int = 2,
                 rows=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = WeightedBatchSampler(weights, seed)
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.rows = list(range(batch_size))
        if rows is not None and len(rows) < batch_size:
            if not hasattr(dataset, "skip_draws"):
                raise NotImplementedError(
                    f"{type(dataset).__name__} cannot skip another rank's "
                    "rows (no skip_draws): it is not sharded yet")
            self.rows = [int(r) for r in rows]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        pool = cf.ThreadPoolExecutor(self.num_workers)
        pending = []
        # slot-writer fast path: a dataset exposing getitem_into(index,
        # out, b) writes each sample straight into row b of preallocated
        # batch arrays (the packed+native path resamples directly into the
        # slot), eliminating the per-sample allocation AND the collate
        # stack copy — both measurable on a 1-core host
        into = getattr(self.dataset, "getitem_into", None)
        if into is not None and not getattr(self.dataset, "raw_output",
                                            False):
            into = None  # slot protocol is raw-output-mode only

        own = self.rows
        slot = {p: k for k, p in enumerate(own)}

        def make_batch():
            idx = self.sampler.draw(self.batch_size)
            # a rank submits its rows' decodes in global order, the other
            # rows' skip_draws in between
            if into is None:
                futs, skips = {}, []
                for p, i in enumerate(idx):
                    if p in slot:
                        futs[p] = pool.submit(self.dataset.__getitem__,
                                              int(i))
                    else:
                        skips.append(pool.submit(self.dataset.skip_draws,
                                                 int(i)))
                return [futs[p] for p in own], skips
            # batch arrays are allocated from sample 0's shapes by the
            # FIRST pool job; later slots gate on the allocation event.
            # Everything flows through the pool in submission order so the
            # per-sample RNG consumption order matches the legacy
            # submit-collate path exactly (pinned by
            # tests/test_packed.py::test_slot_writer_path_matches_collate).
            out: Dict[str, np.ndarray] = {}
            ready = threading.Event()
            n_rows = len(own)

            def first(i):
                try:
                    s0 = self.dataset[int(i)]
                    for k, v in s0.items():
                        out[k] = np.empty(
                            (n_rows,) + np.shape(v),
                            np.asarray(v).dtype)
                        out[k][0] = v
                finally:
                    ready.set()

            def rest(i, b):
                ready.wait()
                into(int(i), out, b)

            futs = []
            for p, i in enumerate(idx):
                b = slot.get(p)
                if b is None:
                    futs.append(pool.submit(self.dataset.skip_draws, int(i)))
                elif b == 0:
                    futs.append(pool.submit(first, int(i)))
                else:
                    futs.append(pool.submit(rest, int(i), b))
            return out, futs

        for _ in range(self.prefetch):
            pending.append(make_batch())
        try:
            while True:
                item = pending.pop(0)
                pending.append(make_batch())
                if into is None:
                    futs, skips = item
                    for f in skips:
                        f.result()
                    yield collate([f.result() for f in futs])
                else:
                    out, futs = item
                    for f in futs:
                        f.result()
                    yield out
        finally:
            pool.shutdown(wait=False, cancel_futures=True)


def build_contrast_source(cfg, num_workers: int = 8, rows=None):
    """Dataset registry dispatch (modal2Dataset, dataset.py:1120-1128 +
    loader wiring util.py:537-578). Returns (source, n_data,
    steps_per_epoch).  num_workers: the DataSource's decode threads (the
    JAX package fixes 8); rows: the global batch's rows this source
    decodes (DataSource)."""
    from .ntu import NTURGBDPairs, NTUSkeleton3D, NTUHeatmap
    from .combined import NTUMPIIGCN, NTUCOCOGCN, NTUSegJoint

    key = cfg.dataset + cfg.modal
    random_flip = bool(cfg.random_flip)
    kw = dict(size=cfg.crop_size, random_flip=random_flip,
              random_resized_crop=True, seed=cfg.seed)
    with_grid = cfg.arch == "HRNetPN"

    ntu_dataset = None
    if cfg.packed_dir:
        from .packed import PackedNTUSkeleton

        ntu_dataset = PackedNTUSkeleton(cfg.packed_dir, **kw)

    if key == "NTUMPIIRGBD2S":
        ds = NTUMPIIGCN(cfg.data_folder, cfg.train_file_list,
                        cfg.mpii_root, "train", with_grid=with_grid,
                        ntu_dataset=ntu_dataset, **kw)
        first_len, second_len = ds.aux_len, len(ds) - ds.aux_len
    elif key == "NTUCOCORGBD2S":
        ds = NTUCOCOGCN(cfg.data_folder, cfg.train_file_list,
                        cfg.coco_root, "train2014", with_grid=with_grid,
                        ntu_dataset=ntu_dataset, **kw)
        first_len, second_len = ds.aux_len, len(ds) - ds.aux_len
    elif key == "NTUSegRGBD2S":
        kw["random_flip"] = False  # seg labels are not flip-aware
        ds = NTUSegJoint(cfg.data_folder, cfg.train_file_list, cfg.seg_root,
                         cfg.seg_file_list, only_seg=False,
                         mask_seg_depth=cfg.mask_seg_depth,
                         mask_seg_rgb=cfg.mask_seg_rgb, **kw)
        first_len, second_len = ds.split, ds.aux_len
    elif key in ("NTURGBD", "NTURGBDS", "NTURGBDHM"):
        cls = {"NTURGBD": NTURGBDPairs, "NTURGBDS": NTUSkeleton3D,
               "NTURGBDHM": NTUHeatmap}[key]
        ds = cls(cfg.data_folder, cfg.train_file_list, **kw)
        first_len, second_len = len(ds), len(ds)
    elif cfg.dataset in ("folder", ""):
        # ImageFolder baselines (InsDis/MoCo/CMC/PIRL on class-folder data,
        # ImageFolderInstance, dataset.py:9-45)
        from .contrast_folder import ContrastImageFolder

        ds = ContrastImageFolder(
            cfg.data_folder, aug=cfg.aug, modal=cfg.modal,
            two_crop=(cfg.mem == "moco"), jigsaw=cfg.jigsaw,
            size=cfg.crop_size, use_memory_bank=cfg.mem.startswith("bank"),
            seed=cfg.seed)
        first_len, second_len = len(ds), len(ds)
    else:
        raise NotImplementedError(f"dataset key {key}")

    if cfg.not_use_weighted_sampler or first_len == len(ds):
        weights = np.ones(len(ds))
    else:
        weights = mixing_weights(len(ds), first_len, second_len)

    source = DataSource(ds, cfg.batch_size, weights, seed=cfg.seed,
                        num_workers=num_workers, rows=rows)
    steps_per_epoch = max(len(ds) // cfg.batch_size, 1)
    return source, len(ds), steps_per_epoch


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host numpy batch -> tensors on `device` (the JAX package's
    shard_batch on one device).  For the card each array is copied once
    into pinned host memory and uploaded with non_blocking=True on the
    current stream, so the upload overlaps the host's next work; the
    pinned buffers go back to torch's caching host allocator only once
    their copy has run.  On the CPU the arrays are shared, not copied."""
    device = torch.device(device)
    if device.type != "cuda":
        return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    return {k: torch.from_numpy(np.asarray(v)).pin_memory().to(
        device, non_blocking=True) for k, v in batch.items()}
