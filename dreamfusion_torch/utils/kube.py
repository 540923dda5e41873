"""Kubernetes job runner (counterpart of dreamfusion_tpu/utils/kube.py;
reference: utils/kubernetes_runner.py:17-177 + utils/kubernetes_backend.py).

The reference runs inside an Atlas pod and uses the `kubernetes` python
client to create a Deployment, wait for its replica, kubectl-cp the job
code in, exec the training command while streaming + classifying logs
(OOM / "No GPUs available." / CUDNN errors mark the attempt retryable,
kubernetes_runner.py:92-98), fetch `job_info.pkl` artifacts back, delete
the Deployment in `finally`, and retry the whole job <=10 times with 60 s
backoff (:168-177).

This implementation drives everything through the `kubectl` binary
(subprocess) instead of the python client — no extra dependency, and the
binary path is injectable so tests can drive the full flow with a scripted
fake kubectl. Manifests are JSON (kubectl accepts JSON wherever it accepts
YAML). The Deployment asks for ``nvidia.com/gpu`` (the JAX package's asks
for ``google.com/tpu``), and the retryable signatures are the reference's
CUDA ones with the port's CUDA failures (no CUDA device, an NCCL error) in
place of the JAX package's TPU ones.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from dreamfusion_torch.utils.backend import RETRYABLE_ERRORS

# log signatures that mark an attempt as retryable-on-another-node
# (reference: kubernetes_runner.py:92-98): the backend's list
RETRYABLE_SIGNATURES = RETRYABLE_ERRORS


def classify_failure(text: str) -> Optional[str]:
    """Return the matched retryable signature, or None if the text is clean."""
    for sig in RETRYABLE_SIGNATURES:
        if sig in text:
            return sig
    return None


def make_deployment_manifest(job_id: str, *, image: str,
                             num_accelerators: int = 1,
                             accelerator_resource: str = "nvidia.com/gpu",
                             namespace: str = "default",
                             env: Optional[Dict[str, str]] = None,
                             command: Optional[List[str]] = None) -> dict:
    """Build the single-replica Deployment the runner patches per job
    (reference: kubernetes_runner.py:156-166 edits name/labels/gpu count on
    a template; we generate the whole manifest instead)."""
    env_list = [{"name": k, "value": str(v)} for k, v in (env or {}).items()]
    env_list.append({"name": "NUM_ACCELERATORS", "value": str(num_accelerators)})
    res = {accelerator_resource: num_accelerators}
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": f"{job_id}-deployment", "namespace": namespace},
        "spec": {
            "replicas": 1,  # reference: one pod per job (:166)
            "selector": {"matchLabels": {"name": f"{job_id}-pod"}},
            "template": {
                "metadata": {"labels": {"name": f"{job_id}-pod"}},
                "spec": {
                    "containers": [{
                        "name": "job",
                        "image": image,
                        "command": command or ["sleep", "infinity"],
                        "env": env_list,
                        "resources": {"limits": dict(res),
                                      "requests": dict(res)},
                    }],
                },
            },
        },
    }


@dataclass
class KubeRunner:
    """One job attempt on a cluster: create -> wait -> cp -> exec (stream +
    classify) -> fetch results -> always delete."""

    namespace: str = "default"
    kubectl: str = "kubectl"
    backend: Any = None            # log_metric/log_params/save_artifact sink
    poll_interval: float = 1.0
    ready_timeout: float = 600.0
    calls: List[List[str]] = field(default_factory=list)   # for inspection
    last_exec_rc: Optional[int] = None   # returncode of the last exec_stream

    # -- kubectl plumbing --------------------------------------------------------
    def _run(self, *args: str, input_text: Optional[str] = None,
             check: bool = True) -> subprocess.CompletedProcess:
        cmd = [self.kubectl, "-n", self.namespace, *args]
        self.calls.append(cmd)
        return subprocess.run(cmd, input=input_text, capture_output=True,
                              text=True, check=check)

    def _log(self, *args):
        if self.backend is not None:
            self.backend.log(*args)
        else:
            print("[kube]", *args)

    # -- lifecycle ---------------------------------------------------------------
    def create_deployment(self, manifest: dict) -> str:
        self._run("apply", "-f", "-", input_text=json.dumps(manifest))
        return manifest["metadata"]["name"]

    def wait_for_pod(self, job_id: str) -> str:
        """Wait until the job's pod is Running and return its name
        (reference waits on available_replicas, :34-50)."""
        deadline = time.monotonic() + self.ready_timeout
        while time.monotonic() < deadline:
            out = self._run("get", "pods", "-l", f"name={job_id}-pod",
                            "-o", "json").stdout
            items = json.loads(out or "{}").get("items", [])
            for pod in items:
                if pod.get("status", {}).get("phase") == "Running":
                    name = pod["metadata"]["name"]
                    self._log("pod found with pod name =", name,
                              "ip =", pod.get("status", {}).get("podIP"))
                    return name
            time.sleep(self.poll_interval)
        raise TimeoutError(f"pod for job {job_id} not Running within "
                           f"{self.ready_timeout}s")

    def copy_code(self, pod: str, src_dir: str, dst: str = "/job"):
        """kubectl cp the job source into the pod (reference :74-76)."""
        self._run("exec", pod, "--", "mkdir", "-p", dst)
        self._run("cp", src_dir, f"{self.namespace}/{pod}:{dst}")

    def exec_stream(self, pod: str, command: str) -> Optional[str]:
        """Run the training command in the pod, streaming combined output to
        the backend log line by line; return the retryable failure signature
        if one appears (reference :79-101)."""
        cmd = [self.kubectl, "-n", self.namespace, "exec", pod, "--",
               "/bin/sh", "-c", command]
        self.calls.append(cmd)
        failure = None
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        assert proc.stdout is not None
        for line in proc.stdout:
            line = line.rstrip("\n")
            failure = failure or classify_failure(line)
            # the reference suppresses lightning's seed chatter (:98)
            if not line.startswith("Global seed set to"):
                self._log(line)
        proc.wait()
        self.last_exec_rc = proc.returncode
        if failure is None and proc.returncode not in (0, None):
            self._log(f"job exec exited rc={proc.returncode}")
        return failure

    def fetch(self, pod: str, relpath: str, dst_dir: str = "."):
        """Copy a result file back out of the pod (reference :11-13)."""
        dst = os.path.join(dst_dir, relpath)
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        # check=False: a job may legitimately produce no job_info.json;
        # the caller's os.path.exists guard decides what that means
        self._run("cp", f"{self.namespace}/{pod}:/job/job_source/{relpath}",
                  dst, check=False)
        return dst

    def delete_deployment(self, name: str):
        self._run("delete", "deployment", name, check=False)

    # -- one attempt -------------------------------------------------------------
    def run_job(self, job_id: str, manifest: dict, *, job_directory: str,
                command: str, workdir: str = ".") -> Optional[str]:
        """One attempt; returns the retryable failure signature or None on
        success. Mirrors kubernetes_runner.run_job: the Deployment is ALWAYS
        torn down, even on exceptions (:123-126)."""
        name = self.create_deployment(manifest)
        try:
            pod = self.wait_for_pod(job_id)
            self.copy_code(pod, job_directory)
            failure = self.exec_stream(
                pod, f"mv /job/{os.path.basename(job_directory)} "
                     f"/job/job_source && cd /job/job_source && {command}")
            if failure is not None:
                return failure
            if self.last_exec_rc not in (0, None):
                # non-zero exit without a retryable signature: a genuine job
                # failure — do NOT retry it on another node, and do NOT
                # treat it as success (it usually has no job_info.json)
                raise RuntimeError(
                    f"job {job_id} command exited rc={self.last_exec_rc} "
                    f"with no retryable infra signature")
            # collect results: job_info.json {params, results, artifacts,
            # tensorboard_path} (reference uses job_info.pkl, :106-121)
            info_path = self.fetch(pod, "job_info.json", workdir)
            if os.path.exists(info_path):
                with open(info_path) as f:
                    info = json.load(f)
                if self.backend is not None:
                    if info.get("params"):
                        self.backend.log_params(info["params"])
                    if info.get("tensorboard_path"):
                        self.backend.set_tensorboard_logdir(
                            info["tensorboard_path"])
                        self.fetch(pod, info["tensorboard_path"], workdir)
                    for key, path in info.get("artifacts", {}).items():
                        local = self.fetch(pod, path, workdir)
                        self.backend.save_artifact(local, name=key)
                    for key, value in info.get("results", {}).items():
                        self.backend.log_metric(key, value)
            return None
        finally:
            self.delete_deployment(name)


def submit_kube_job(job_id: str, manifest: dict, *, runner: KubeRunner,
                    job_directory: str, command: str, workdir: str = ".",
                    max_retries: int = 10,
                    retry_sleep: float = 60.0) -> None:
    """Retry wrapper (reference :168-177): re-run the attempt while it fails
    with a retryable infra error, <=max_retries times, sleeping between."""
    failure = "unattempted"
    for _ in range(max_retries):
        failure = runner.run_job(job_id, manifest,
                                 job_directory=job_directory,
                                 command=command, workdir=workdir)
        if failure is None:
            return
        runner._log(f"retryable failure: {failure!r}; backing off "
                    f"{retry_sleep}s")
        time.sleep(retry_sleep)
    raise RuntimeError(
        f"No available node can be found! last failure: {failure!r}")


def kubectl_available(kubectl: str = "kubectl") -> bool:
    return shutil.which(kubectl) is not None
