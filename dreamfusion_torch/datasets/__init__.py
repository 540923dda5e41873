"""Real multi-view datasets for DVGO pretraining (pipeline 3): the port's
own numpy copy of dreamfusion_tpu/datasets (the port imports nothing of the
JAX package). Batches are numpy arrays; the trainer moves them to its
device:

- loaders.py   — `load_data(cfg)` dispatch over the dataset formats
                 (reference: datasets/nerf/lib/load_data.py:20-197)
- rays.py      — per-view ray generation (pinhole/panoramic/NDC) and the
                 ray-gathering samplers (reference: datasets/nerf/utils.py,
                 datasets/nerf/nerf_dataset.py:86-139)
- provider.py  — DataProvider / DatasetFactory with the name-suffix grammar
                 (_test/_train/_val/_swap/_noaug/_partial/_ordered/_rand)
                 (reference: datasets/dataProvider.py:52-199)
"""

from dreamfusion_torch.datasets.provider import DataProvider, DatasetFactory  # noqa: F401
from dreamfusion_torch.datasets.loaders import load_data, inward_nearfar_heuristic  # noqa: F401
