"""Split loading, the RAM-cached dataset and a threaded prefetching loader:
the port's copy of vs_seg_tpu/data/dataset.py.

  load_split_csv  CSV rows (case, split) -> image/label path dicts under
                  data_root/input_data/<case>/vs_gk_{t1,t2,seg}_ref{T1,T2}
                  .nii.gz, with existence checks (reference
                  VSparams.load_T1_or_T2_data)
  CacheDataset    monai.data.CacheDataset(cache_rate=1.0): the deterministic
                  transform prefix once, the random suffix per fetch
  collate         monai list_data_collate
  DataLoader      per-epoch shuffle and random-transform draws from
                  `np.random.Generator`s seeded by (seed, epoch); optional
                  prefetch on worker threads; under data parallelism only
                  the rank's rows of each batch
"""

from __future__ import annotations

import csv
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vs_seg_tpu_torch.data.transforms import Compose

_ARRAY_KEYS = ("image", "label")


def load_split_csv(split_csv: str, dataset: str, data_root: str
                   ) -> Tuple[List[dict], List[dict], List[dict]]:
    """CSV rows (case_id, split) -> (train, val, test) path-dict lists."""
    if dataset not in ("T1", "T2"):
        raise ValueError(f'dataset must be "T1" or "T2", got {dataset!r}')
    tag = "t1" if dataset == "T1" else "t2"
    train_files: List[dict] = []
    val_files: List[dict] = []
    test_files: List[dict] = []
    buckets = {"training": train_files, "validation": val_files,
               "test": test_files}
    with open(split_csv) as f:
        for row in csv.reader(f):
            if not row:
                continue
            if len(row) < 2:
                raise ValueError(
                    f"malformed split row {row!r} in {split_csv}: expected "
                    "'case_id,split'")
            case, split = row[0].strip(), row[1].strip()
            base = os.path.join(data_root, "input_data", case)
            entry = {
                "image": os.path.join(base, f"vs_gk_{tag}_ref{dataset}.nii.gz"),
                "label": os.path.join(base, f"vs_gk_seg_ref{dataset}.nii.gz"),
            }
            if split in buckets:
                buckets[split].append(entry)
    for file_dict in train_files + val_files + test_files:
        for key in ("image", "label"):
            if not os.path.isfile(file_dict[key]):
                raise FileNotFoundError(f" {file_dict[key]} is not a file")
    return train_files, val_files, test_files


class CacheDataset:
    """Precompute the deterministic transform prefix once (threaded), keep it
    in RAM; apply the random suffix per fetch."""

    def __init__(self, files: Sequence[dict], transform: Compose,
                 num_workers: int = 1):
        self.transform = transform
        prefix, suffix = transform.deterministic_prefix_split()
        self._suffix = suffix

        def apply_prefix(file_dict: dict) -> dict:
            sample = dict(file_dict)
            for t in prefix:
                sample = t(sample)
            return sample

        if num_workers > 1 and len(files) > 1:
            with ThreadPoolExecutor(num_workers) as pool:
                self.cache = list(pool.map(apply_prefix, files))
        else:
            self.cache = [apply_prefix(f) for f in files]

    def __len__(self) -> int:
        return len(self.cache)

    def get(self, index: int, rng: np.random.Generator) -> dict:
        sample = dict(self.cache[index])  # arrays shared; suffix never mutates
        for t in self._suffix:
            sample = t(sample, rng) if t.is_random else t(sample)
        return sample


def collate(samples: Sequence[dict]) -> Dict[str, object]:
    """Dict-batch collation: arrays stack along a new batch dim; meta and
    other entries become lists."""
    batch: Dict[str, object] = {}
    for key in samples[0]:
        values = [s[key] for s in samples]
        if key in _ARRAY_KEYS:
            batch[key] = np.stack(values)
        else:
            batch[key] = values
    return batch


class DataLoader:
    """Iterable of collated dict batches. Every `__iter__` is a new epoch:
    fresh shuffle order and fresh random-transform draws.

    prefetch=N overlaps host transform work for the next N batches with
    whatever the caller does between batches.

    With `ranks` (parallel/distributed.py:Ranks) every rank draws the epoch
    plan of the whole batch, order and per-sample seeds, from the same
    generator, and materialises only its rows of each batch
    (Ranks.rows); each batch then carries "replicated", whether every rank
    holds the whole batch."""

    def __init__(self, dataset: CacheDataset, batch_size: int = 1,
                 shuffle: bool = False, seed: Optional[int] = None,
                 prefetch: Optional[int] = None, ranks=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = 0 if seed is None else seed
        self.prefetch = prefetch
        self.ranks = ranks
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_plan(self):
        """[(indices, seeds, replicated)] of the epoch's batches
        (replicated None without ranks)."""
        epoch = self._epoch
        self._epoch += 1
        root = np.random.default_rng([self.seed, epoch])
        order = (root.permutation(len(self.dataset)) if self.shuffle
                 else np.arange(len(self.dataset)))
        seeds = root.integers(0, 2 ** 63 - 1, size=len(order))
        plan = []
        for i in range(0, len(order), self.batch_size):
            idx = order[i:i + self.batch_size]
            sd = seeds[i:i + self.batch_size]
            if self.ranks is None:
                plan.append((idx, sd, None))
            else:
                rows, replicated = self.ranks.rows(len(idx))
                plan.append((idx[rows], sd[rows], replicated))
        return plan

    def _make_batch(self, indices, seeds, replicated) -> Dict[str, object]:
        samples = [self.dataset.get(int(i), np.random.default_rng(int(s)))
                   for i, s in zip(indices, seeds)]
        batch = collate(samples)
        if replicated is not None:
            batch["replicated"] = replicated
        return batch

    def __iter__(self):
        plan = self._epoch_plan()
        if not self.prefetch or self.prefetch <= 1 or len(plan) <= 1:
            for step in plan:
                yield self._make_batch(*step)
            return

        pool = ThreadPoolExecutor(max_workers=self.prefetch)
        try:
            pending = deque()
            it = iter(plan)
            for _ in range(self.prefetch):
                nxt = next(it, None)
                if nxt is None:
                    break
                pending.append(pool.submit(self._make_batch, *nxt))
            while pending:
                batch = pending.popleft().result()
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.submit(self._make_batch, *nxt))
                yield batch
        finally:
            # cancel queued work too: an epoch abandoned early leaves no
            # task running
            pool.shutdown(wait=False, cancel_futures=True)
