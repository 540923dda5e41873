"""DataProvider / DatasetFactory: name-suffix-driven dataset construction
plus simple numpy batch iterators (the port's copy of
dreamfusion_tpu/datasets/provider.py; its shuffles use numpy RandomState,
so both packages give the same batches).

Rebuilds datasets/dataProvider.py: the suffix grammar mutates the split
mapping and decorations —
  _test/_train/_val  -> all three splits read from that split
  _swap              -> rotate (train, val, test) -> (val, test, train)
  _noaug/_allaug     -> transform selection (no-op for ray datasets)
  _partial           -> PartialDataset(total, selected) on train
  _ordered           -> deterministic order
  _rand              -> label-randomization decorator (RandDataset)
(reference: dataProvider.py:79-134, decorators.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np


class ArrayDataset:
    """A tuple-of-arrays dataset: item i = (inputs..., target)."""

    def __init__(self, *arrays: np.ndarray):
        assert all(len(a) == len(arrays[0]) for a in arrays)
        self.arrays = arrays

    def __len__(self):
        return len(self.arrays[0])

    def __getitem__(self, i):
        return tuple(a[i] for a in self.arrays)

    def select(self, idx: np.ndarray) -> "ArrayDataset":
        return ArrayDataset(*(a[idx] for a in self.arrays))


class PartialDataset(ArrayDataset):
    """First `selected` of every `total` block (reference: decorators.py)."""

    def __init__(self, base: ArrayDataset, total: int, selected: int):
        idx = np.arange(len(base))
        keep = idx[(idx % total) < selected]
        super().__init__(*(a[keep] for a in base.arrays))


class RandDataset(ArrayDataset):
    """Replace targets with deterministic pseudo-random values, mixing
    coefficient alpha (reference: decorators.py RandDataset)."""

    def __init__(self, base: ArrayDataset, alpha: float, seed: int = 0):
        arrays = list(base.arrays)
        rng = np.random.RandomState(seed)
        t = arrays[-1]
        arrays[-1] = (1 - alpha) * t + alpha * rng.permutation(t)
        super().__init__(*arrays)


class ConcatDataset(ArrayDataset):
    """Concatenate several ArrayDatasets (the 'concat' factory name /
    repeat>1 loader behavior, dataProvider.py:43-46, 64-69)."""

    def __init__(self, datasets: Sequence[ArrayDataset]):
        arrays = [np.concatenate([d.arrays[i] for d in datasets])
                  for i in range(len(datasets[0].arrays))]
        super().__init__(*arrays)


class OrderDataset(ArrayDataset):
    """Deterministic class/target-ordered iteration (decorators.py
    OrderDataset; for ray datasets, orders by target luminance)."""

    def __init__(self, base: ArrayDataset):
        t = base.arrays[-1]
        keys = t.reshape(len(t), -1).mean(-1)
        order = np.argsort(keys, kind="stable")
        super().__init__(*(a[order] for a in base.arrays))


class DataLoaderLite:
    """Batched iterator over an ArrayDataset (shuffle per epoch, drop_last)."""

    def __init__(self, dataset: ArrayDataset, batch_size: int,
                 shuffle: bool = False, drop_last: bool = False, seed: int = 0,
                 repeat: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._epoch = 0
        self._seed = seed
        self.repeat = repeat

    def __len__(self):
        n = len(self.dataset) * self.repeat
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        n = len(self.dataset)
        idx = np.concatenate([np.arange(n)] * self.repeat)
        if self.shuffle:
            rng = np.random.RandomState(self._seed + self._epoch)
            rng.shuffle(idx)
        self._epoch += 1
        bs = self.batch_size
        stop = (len(idx) // bs) * bs if self.drop_last else len(idx)
        for s in range(0, stop, bs):
            batch = idx[s: s + bs]
            yield tuple(a[batch] for a in self.dataset.arrays)


@dataclass
class FullDataset:
    """Train/val/test ArrayDatasets + metadata."""
    train: ArrayDataset
    val: ArrayDataset
    test: ArrayDataset
    meta: Dict


class DatasetFactory:
    """Name suffix grammar -> concrete split datasets."""

    @staticmethod
    def analyze_name(name: str, params: Dict) -> Tuple[str, Dict]:
        params = dict(params)
        params.setdefault("dataset_mapping", (0, 1, 2))
        while True:
            if name.endswith("_partial"):
                name = name[:-8]
                params["partial_train"] = True
            elif name.endswith("_test"):
                name = name[:-5]
                params["dataset_mapping"] = (2, 2, 2)
            elif name.endswith("_train"):
                name = name[:-6]
                params["dataset_mapping"] = (0, 0, 0)
            elif name.endswith("_val"):
                name = name[:-4]
                params["dataset_mapping"] = (1, 1, 1)
            elif name.endswith("_swap"):
                name = name[:-5]
                a, b, c = params["dataset_mapping"]
                params["dataset_mapping"] = (b, c, a)
            elif name.endswith("_noaug") or name.endswith("_allaug"):
                name = name.rsplit("_", 1)[0]
            elif name.endswith("_ordered"):
                name = name[:-8]
                params["order_all"] = True
            elif name.endswith("_rand"):
                name = name[:-5]
                params["rand_dataset"] = True
            else:
                break
        return name, params

    @staticmethod
    def build_dataset(params: Dict) -> FullDataset:
        name, params = DatasetFactory.analyze_name(params["name"], params)
        if name.lower() != "nerf":
            raise NotImplementedError(f"dataset {name!r} (only the NeRF ray "
                                      "dataset family is ported)")
        from dreamfusion_torch.datasets.loaders import load_data
        from dreamfusion_torch.datasets.rays import gather_training_rays

        data_dict = params.get("data_dict") or load_data(params["cfg_data"])
        cfg_data = dict(params.get("cfg_data_dict", {}))
        sampler = params.get("ray_sampler", "random")
        test_sampler = "stanford" if "stanford" in sampler else "random"

        splits = []
        caps = {"i_train": None, "i_val": 819200, "i_test": 819200}
        for split, s in (("i_train", sampler), ("i_val", test_sampler),
                         ("i_test", test_sampler)):
            rgb, ro, rd, vd, _ = gather_training_rays(
                data_dict, cfg_data, split=split, ray_sampler=s,
                mask_fn=params.get("mask_fn"))
            ds = ArrayDataset(rd, ro, vd, rgb)
            cap = caps[split]  # val/test ray cap (nerf_dataset.py:43-50)
            if cap and len(ds) > cap:
                keep = np.random.RandomState(0).permutation(len(ds))[:cap]
                ds = ds.select(keep)
            splits.append(ds)

        m = params["dataset_mapping"]
        picked = [splits[m[i]] for i in range(3)]
        if params.get("partial_train"):
            picked[0] = PartialDataset(picked[0], params["total"],
                                       params["selected"])
        if params.get("rand_dataset"):
            picked = [RandDataset(d, params["alpha"]) for d in picked]
        return FullDataset(train=picked[0], val=picked[1], test=picked[2],
                           meta=data_dict)


class DataProvider:
    """params dict -> train_dl/val_dl/test_dl (reference: dataProvider.py:9-49)."""

    def __init__(self, params: Dict):
        params = dict(params)
        full = DatasetFactory.build_dataset(params)
        self.dataset = full
        bz = params.get("batch_size", 4096)
        train_bz = params.get("train_bz", bz)
        test_bz = params.get("test_bz", bz)
        repeat = params.get("repeat", 1)
        self.train_dl = DataLoaderLite(full.train, train_bz, shuffle=True,
                                       repeat=repeat,
                                       drop_last=params.get("drop_last", False))
        self.val_dl = DataLoaderLite(full.val, test_bz)
        self.test_dl = DataLoaderLite(full.test, test_bz)
