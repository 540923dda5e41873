"""Cluster and job orchestration (L7) of the port (counterpart of
dreamfusion_tpu/utils/; reference utils/): a uniform backend API
{submit, load_parameters, log_params, log_metric, save_artifact,
set_tensorboard_logdir, log} selected at import time (utils/backend.py),
with a local subprocess backend, a Kubernetes backend driving ``kubectl``
(utils/kube.py) and an Atlas stub, the experiment tooling of utils/tools.py
(submit_jobs' dedupe loop, random_params sweeps, parse_params' defaults)
and the result tools of utils/results.py. All of it is host Python; the
jobs it launches run the port (training/jobs.py).
"""

from dreamfusion_torch.utils import backend  # noqa: F401
from dreamfusion_torch.utils.tools import (  # noqa: F401
    submit_jobs, random_params, parse_params, get_model_weight_hash,
    skip_if_excuted)
