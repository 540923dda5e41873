"""Pluggable job backend (counterpart of dreamfusion_tpu/utils/backend.py;
reference utils/backend.py and its local, Atlas and Kubernetes backends).

Selection at import time (reference utils/backend.py:2-12): a marker file
``use_kubernets.backend`` in the working directory -> kubernetes; env
ATLAS_BACKEND -> atlas; otherwise local. All expose the same API:

    submit(function_path, params)  launch a training job
    load_parameters()              job side: fetch its params dict
    log_params(params) / log_metric(key, value) / log(msg)
    save_artifact(path, name) / set_tensorboard_logdir(path)

The local backend pickles the params and launches a subprocess
(utils/local_backend.py:50-58) that imports the port; the Kubernetes
backend keeps the reference's retry-on-infrastructure-error loop
(utils/kubernetes_runner.py:168-177) around a kubectl runner
(utils/kube.py); Atlas is a stub that clips metrics. The environment
names (DFTPU_PARAMS_FILE, DFTPU_JOB_DIR, DFTPU_JOBS_ROOT, DFTPU_KUBE*)
are the JAX package's, so a user's cluster settings carry over.

The Kubernetes job's parameters travel in ``kube_job_parameters.yaml``,
written as JSON (which a YAML reader also takes) and read with json, so
the port needs no YAML library. A value arrives as itself when JSON
carries it (None, bool, int, float, str, and lists, tuples and dicts with
string keys of those; a tuple arrives as a list); anything else arrives
as its repr. That is what the JAX package's yaml.safe_dump path delivers
for those and for what it refuses (a numpy scalar, an OrderedDict, an
object); a set, bytes, a date or a dict with non-string keys, which YAML
carries as themselves, arrive here as their repr.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import subprocess
import sys
import time
from typing import Any, Dict, Optional

_PARAM_ENV = "DFTPU_PARAMS_FILE"
_WORKDIR_ENV = "DFTPU_JOB_DIR"

# error signatures that trigger a retry (utils/kubernetes_runner.py:92-98,
# with the CUDA failures of the port's jobs)
RETRYABLE_ERRORS = (
    "out of memory",                      # torch's "CUDA out of memory"
    "No GPUs available.",
    "CUDNN_STATUS_INTERNAL_ERROR",
    "no CUDA-capable device is detected",
    "No CUDA GPUs are available",
    "NCCL error",
)

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def job_code(function_path: str) -> str:
    """The Python source a job runs: import the port's module of
    'module:function', fetch the parameters through the port's backend and
    call the function with them."""
    mod, fn = function_path.split(":")
    return (f"import {mod}; from dreamfusion_torch.utils import backend; "
            f"{mod}.{fn}(backend.load_parameters())")


def _json_exact(v) -> bool:
    if v is None or type(v) in (bool, int, float, str):
        return True
    if type(v) in (list, tuple):              # a tuple arrives as a list
        return all(_json_exact(x) for x in v)
    if type(v) is dict:
        return all(type(k) is str and _json_exact(x) for k, x in v.items())
    return False


def job_param(v):
    """A parameter as the Kubernetes job receives it: itself when JSON
    carries it exactly, else its repr (see the module docstring)."""
    return v if _json_exact(v) else repr(v)


class LocalBackend:
    """Run jobs as local subprocesses (reference: utils/local_backend.py)."""

    name = "local"

    def __init__(self, root: Optional[str] = None):
        self.root = root or os.environ.get("DFTPU_JOBS_ROOT", "jobs")

    def _job_dir(self) -> str:
        d = os.path.join(self.root, time.strftime("%Y%m%d_%H%M%S_")
                         + str(os.getpid()))
        os.makedirs(d, exist_ok=True)
        return d

    def submit(self, function_path: str, params: Dict[str, Any],
               blocking: bool = True) -> int:
        """function_path: 'module:function' taking a params dict. Returns
        the job's exit code (blocking) or its pid."""
        job_dir = self._job_dir()
        pfile = os.path.join(job_dir, "params.pkl")
        with open(pfile, "wb") as f:
            pickle.dump(params, f)
        pypath = os.pathsep.join(
            p for p in [PKG_ROOT, os.environ.get("PYTHONPATH", "")] if p)
        env = dict(os.environ, **{_PARAM_ENV: pfile, _WORKDIR_ENV: job_dir,
                                  "PYTHONPATH": pypath})
        proc = subprocess.Popen([sys.executable, "-c",
                                 job_code(function_path)], env=env)
        if blocking:
            return proc.wait()
        return proc.pid

    # job-side API --------------------------------------------------------------
    @staticmethod
    def load_parameters() -> Dict[str, Any]:
        pfile = os.environ.get(_PARAM_ENV)
        if pfile and os.path.exists(pfile):
            if pfile.endswith((".yaml", ".yml")):   # kube jobs: JSON inside
                with open(pfile) as f:
                    return json.load(f).get("params", {})
            with open(pfile, "rb") as f:
                return pickle.load(f)
        return {}

    def _meta_path(self, name: str) -> str:
        d = os.environ.get(_WORKDIR_ENV, self.root)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, name)

    def log_params(self, params: Dict[str, Any]):
        with open(self._meta_path("params.json"), "w") as f:
            json.dump({k: repr(v) for k, v in params.items()}, f, indent=1)

    def log_metric(self, key: str, value):
        with open(self._meta_path("metrics.jsonl"), "a") as f:
            f.write(json.dumps({key: float(value), "time": time.time()}) + "\n")

    def save_artifact(self, path: str, name: Optional[str] = None):
        dst = self._meta_path(name or os.path.basename(path))
        if os.path.abspath(path) != os.path.abspath(dst):
            shutil.copy(path, dst)

    def set_tensorboard_logdir(self, path: str):
        with open(self._meta_path("tensorboard.txt"), "w") as f:
            f.write(path)

    def log(self, *args):
        print("[backend]", *args, flush=True)


class KubernetesBackend(LocalBackend):
    """Kubernetes job runner: a Deployment per job created through kubectl,
    the code copied in, the command exec'd with its log streamed and
    classified (utils/kube.py), teardown in finally, up to 10 retries with
    backoff (reference: utils/kubernetes_backend.py, kubernetes_runner.py:
    17-177). kubectl's path, the image, the namespace and the GPU count
    come from the environment, so tests drive it with a scripted kubectl."""

    name = "kubernetes"
    max_retries = 10
    retry_sleep = 60.0

    def __init__(self, root: Optional[str] = None):
        super().__init__(root)
        self.kubectl = os.environ.get("DFTPU_KUBECTL", "kubectl")
        self.namespace = os.environ.get("DFTPU_KUBE_NAMESPACE", "default")
        self.image = os.environ.get("DFTPU_KUBE_IMAGE",
                                    "dreamfusion-torch:latest")
        self.num_accelerators = int(os.environ.get("DFTPU_KUBE_ACCELS", "1"))

    def submit(self, function_path: str, params: Dict[str, Any],
               blocking: bool = True) -> int:
        from dreamfusion_torch.utils import kube

        if not kube.kubectl_available(self.kubectl):
            raise RuntimeError(
                "kubernetes backend selected but kubectl is not available; "
                "remove use_kubernets.backend or set LOCAL_BACKEND=1")
        job_dir = self._job_dir()
        job_id = os.path.basename(job_dir).replace("_", "-").lower()
        # the job's params ride in next to the code (reference:
        # kube_job_parameters.yaml, kubernetes_runner.py:147-148)
        with open(os.path.join(job_dir, "kube_job_parameters.yaml"),
                  "w") as f:
            json.dump({"function_path": function_path,
                       "params": {k: job_param(v) for k, v in params.items()}},
                      f, indent=1)
        command = f"python -c '{job_code(function_path)}'"
        manifest = kube.make_deployment_manifest(
            job_id, image=self.image,
            num_accelerators=self.num_accelerators,
            namespace=self.namespace,
            env={_PARAM_ENV: "/job/job_source/kube_job_parameters.yaml"})
        runner = kube.KubeRunner(namespace=self.namespace,
                                 kubectl=self.kubectl, backend=self)
        try:
            kube.submit_kube_job(job_id, manifest, runner=runner,
                                 job_directory=PKG_ROOT, command=command,
                                 workdir=job_dir,
                                 max_retries=self.max_retries,
                                 retry_sleep=self.retry_sleep)
            return 0
        except RuntimeError as e:
            self.log(str(e))
            return 1


class AtlasBackend(LocalBackend):
    """Atlas/foundations stub with metric clipping
    (reference: utils/atlas_backend.py:9-31)."""

    name = "atlas"

    def log_metric(self, key: str, value):
        v = float(value)
        v = max(min(v, 1e38), -1e38)  # atlas clips extreme metrics
        super().log_metric(key, v)


def _test_job_entry(params):
    """Self-test hook: double params['x'] into a metric (used by tests)."""
    log_metric("result", params["x"] * 2)


def _select_backend():
    if os.path.exists("use_kubernets.backend"):
        return KubernetesBackend()
    if os.environ.get("ATLAS_BACKEND"):
        return AtlasBackend()
    return LocalBackend()


_impl = _select_backend()

submit = _impl.submit
load_parameters = _impl.load_parameters
log_params = _impl.log_params
log_metric = _impl.log_metric
save_artifact = _impl.save_artifact
set_tensorboard_logdir = _impl.set_tensorboard_logdir
log = _impl.log
