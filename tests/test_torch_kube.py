"""The port's Kubernetes runner (dreamfusion_torch/utils/kube.py and the
KubernetesBackend of utils/backend.py), driven end to end by the scripted
fake kubectl of tests/test_kube.py: its cases on the port, with the
differences from the JAX package written down where they are tested
(the Deployment asks for nvidia.com/gpu; the retryable signatures are
CUDA's, not XLA's; the parameters file is JSON read by json, and a job
receives each parameter as the JAX package's yaml path delivers it; the
exec'd command imports the port).

The fake binary logs every invocation to a file and answers:
- `apply`   -> ok
- `get pods`-> one Running pod named <job>-pod-abc (JSON)
- `cp`      -> records; for the results fetch it writes a job_info.json
- `exec`    -> prints a scripted log (scenario file controls whether it
               contains an OOM signature)
- `delete`  -> ok

Covers: manifest shape, pod wait, code copy, log streaming +
classification, result collection, teardown-in-finally, and the retry
loop (reference: utils/kubernetes_runner.py:17-177).
"""

import json
import os
import re
import stat
import textwrap

import pytest

import numpy as np

from dreamfusion_torch.utils.kube import (KubeRunner, classify_failure,
                                          make_deployment_manifest,
                                          submit_kube_job)


FAKE_KUBECTL = textwrap.dedent("""\
    #!/bin/bash
    # scripted kubectl: $FAKE_DIR holds calls.log, scenario, job_info.json
    echo "$@" >> "$FAKE_DIR/calls.log"
    shift 2   # drop "-n <namespace>"
    case "$1" in
      apply) cat > /dev/null; echo ok ;;
      get)
        cat "$FAKE_DIR/pods.json" ;;
      cp)
        # fetching results back? (src starts with <ns>/<pod>:)
        if [[ "$2" == */job/job_source/job_info.json ]]; then
          cp "$FAKE_DIR/job_info.json" "$3" 2>/dev/null || true
        fi ;;
      exec)
        # args: exec <pod> -- <cmd...>
        if [[ "$4" == mkdir ]]; then exit 0; fi
        cat "$FAKE_DIR/scenario_$(cat "$FAKE_DIR/attempt")".log
        echo $(( $(cat "$FAKE_DIR/attempt") + 1 )) > "$FAKE_DIR/attempt"
        if [[ -f "$FAKE_DIR/exec_rc" ]]; then exit "$(cat "$FAKE_DIR/exec_rc")"; fi
        ;;
      delete) echo deleted ;;
    esac
    exit 0
""")


@pytest.fixture
def fake_kubectl(tmp_path, monkeypatch):
    fake_dir = tmp_path / "fake"
    fake_dir.mkdir()
    kubectl = tmp_path / "kubectl"
    kubectl.write_text(FAKE_KUBECTL)
    kubectl.chmod(kubectl.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("FAKE_DIR", str(fake_dir))
    (fake_dir / "attempt").write_text("0")
    (fake_dir / "pods.json").write_text(json.dumps({"items": [{
        "metadata": {"name": "tjob-pod-abc"},
        "status": {"phase": "Running", "podIP": "10.0.0.7"}}]}))
    (fake_dir / "job_info.json").write_text(json.dumps({
        "params": {"lr": "0.001"},
        "results": {"psnr": 31.5},
        "artifacts": {},
        "tensorboard_path": ""}))
    return str(kubectl), fake_dir


class RecordingBackend:
    def __init__(self):
        self.metrics, self.params, self.lines = {}, {}, []

    def log(self, *a):
        self.lines.append(" ".join(str(x) for x in a))

    def log_params(self, p):
        self.params.update(p)

    def log_metric(self, k, v):
        self.metrics[k] = v

    def save_artifact(self, path, name=None):
        pass

    def set_tensorboard_logdir(self, path):
        pass


def test_manifest_shape():
    m = make_deployment_manifest("j1", image="img:1", num_accelerators=4,
                                 namespace="ns")
    assert m["metadata"]["name"] == "j1-deployment"
    assert m["spec"]["replicas"] == 1
    tpl = m["spec"]["template"]
    assert tpl["metadata"]["labels"]["name"] == "j1-pod"
    res = tpl["spec"]["containers"][0]["resources"]
    # the port asks for GPUs (the JAX package: google.com/tpu)
    assert res["limits"] == {"nvidia.com/gpu": 4} == res["requests"]


def test_classify_failure():
    assert classify_failure("CUDA error: out of memory") == "out of memory"
    assert classify_failure("torch.OutOfMemoryError: CUDA out of memory. "
                            "Tried to allocate 2.00 GiB") == "out of memory"
    assert classify_failure("RuntimeError: No CUDA GPUs are available") \
        == "No CUDA GPUs are available"
    assert classify_failure("CUDA error: no CUDA-capable device is detected") \
        == "no CUDA-capable device is detected"
    assert classify_failure("torch.distributed.DistBackendError: NCCL error "
                            "in: ProcessGroupNCCL.cpp:1970") == "NCCL error"
    # the JAX package's TPU signatures are not the port's
    assert classify_failure("RESOURCE_EXHAUSTED: while allocating") is None
    assert classify_failure("No visible TPU devices") is None
    assert classify_failure("step 100 loss 0.5") is None


def test_run_job_success_collects_results(fake_kubectl, tmp_path):
    kubectl, fake_dir = fake_kubectl
    (fake_dir / "scenario_0.log").write_text(
        "Global seed set to 42\nstep 1 loss 0.9\ndone\n")
    be = RecordingBackend()
    runner = KubeRunner(namespace="ns", kubectl=kubectl, backend=be,
                        poll_interval=0.01, ready_timeout=5)
    m = make_deployment_manifest("tjob", image="img", namespace="ns")
    fail = runner.run_job("tjob", m, job_directory=str(tmp_path),
                          command="python train.py",
                          workdir=str(tmp_path))
    assert fail is None
    assert be.metrics == {"psnr": 31.5}
    assert be.params == {"lr": "0.001"}
    # seed chatter suppressed, real log streamed
    assert any("step 1 loss 0.9" in l for l in be.lines)
    assert not any("Global seed" in l for l in be.lines)
    calls = (fake_dir / "calls.log").read_text()
    assert "delete deployment tjob-deployment" in calls   # teardown ran


def test_teardown_runs_even_when_exec_fails(fake_kubectl, tmp_path):
    kubectl, fake_dir = fake_kubectl
    (fake_dir / "scenario_0.log").write_text(
        "CUDA error: out of memory\n")
    runner = KubeRunner(namespace="ns", kubectl=kubectl,
                        backend=RecordingBackend(),
                        poll_interval=0.01, ready_timeout=5)
    m = make_deployment_manifest("tjob", image="img", namespace="ns")
    fail = runner.run_job("tjob", m, job_directory=str(tmp_path),
                          command="python train.py", workdir=str(tmp_path))
    assert fail == "out of memory"
    assert "delete deployment tjob-deployment" in \
        (fake_dir / "calls.log").read_text()


def test_retry_loop_recovers_after_oom(fake_kubectl, tmp_path):
    kubectl, fake_dir = fake_kubectl
    # attempt 0 OOMs, attempt 1 succeeds
    (fake_dir / "scenario_0.log").write_text("out of memory\n")
    (fake_dir / "scenario_1.log").write_text("step 1 ok\n")
    be = RecordingBackend()
    runner = KubeRunner(namespace="ns", kubectl=kubectl, backend=be,
                        poll_interval=0.01, ready_timeout=5)
    m = make_deployment_manifest("tjob", image="img", namespace="ns")
    submit_kube_job("tjob", m, runner=runner, job_directory=str(tmp_path),
                    command="python train.py", workdir=str(tmp_path),
                    max_retries=3, retry_sleep=0.01)
    assert be.metrics == {"psnr": 31.5}
    calls = (fake_dir / "calls.log").read_text()
    assert calls.count("delete deployment tjob-deployment") == 2


def test_retry_loop_gives_up(fake_kubectl, tmp_path):
    kubectl, fake_dir = fake_kubectl
    for i in range(3):
        (fake_dir / f"scenario_{i}.log").write_text("out of memory\n")
    runner = KubeRunner(namespace="ns", kubectl=kubectl,
                        backend=RecordingBackend(),
                        poll_interval=0.01, ready_timeout=5)
    m = make_deployment_manifest("tjob", image="img", namespace="ns")
    with pytest.raises(RuntimeError, match="No available node"):
        submit_kube_job("tjob", m, runner=runner,
                        job_directory=str(tmp_path),
                        command="python train.py", workdir=str(tmp_path),
                        max_retries=3, retry_sleep=0.01)


def test_backend_submit_uses_runner(fake_kubectl, tmp_path, monkeypatch):
    """KubernetesBackend.submit drives the kubectl runner (not a local
    subprocess) and returns 0 on success."""
    kubectl, fake_dir = fake_kubectl
    (fake_dir / "scenario_0.log").write_text("trained\n")
    monkeypatch.setenv("DFTPU_KUBECTL", kubectl)
    monkeypatch.setenv("DFTPU_KUBE_NAMESPACE", "ns")
    monkeypatch.chdir(tmp_path)
    from dreamfusion_torch.utils.backend import KubernetesBackend

    be = KubernetesBackend(root=str(tmp_path / "jobs"))
    rc = be.submit("dreamfusion_torch.utils.backend:_test_job_entry",
                   {"x": 21})
    assert rc == 0
    calls = (fake_dir / "calls.log").read_text()
    assert "apply -f -" in calls and "delete deployment" in calls


def test_nonzero_exit_without_signature_fails_without_retry(
        fake_kubectl, tmp_path):
    """A job that exits non-zero with clean logs is a genuine failure:
    run_job must raise (not fetch-and-crash, not silently succeed), the
    retry loop must NOT re-run it, and submit must return rc=1."""
    kubectl, fake_dir = fake_kubectl
    (fake_dir / "scenario_0.log").write_text("Traceback: ValueError\n")
    (fake_dir / "exec_rc").write_text("3")
    be = RecordingBackend()
    runner = KubeRunner(namespace="ns", kubectl=kubectl, backend=be,
                        poll_interval=0.01, ready_timeout=5)
    m = make_deployment_manifest("tjob", image="img", namespace="ns")
    with pytest.raises(RuntimeError, match="rc=3"):
        submit_kube_job("tjob", m, runner=runner,
                        job_directory=str(tmp_path),
                        command="python train.py", workdir=str(tmp_path),
                        max_retries=3, retry_sleep=0.01)
    calls = (fake_dir / "calls.log").read_text()
    assert calls.count("delete deployment tjob-deployment") == 1  # no retry
    assert be.metrics == {}                    # nothing fetched as success


def test_backend_submit_returns_1_on_plain_job_failure(
        fake_kubectl, tmp_path, monkeypatch):
    kubectl, fake_dir = fake_kubectl
    (fake_dir / "scenario_0.log").write_text("boom\n")
    (fake_dir / "exec_rc").write_text("2")
    monkeypatch.setenv("DFTPU_KUBECTL", kubectl)
    monkeypatch.setenv("DFTPU_KUBE_NAMESPACE", "ns")
    monkeypatch.chdir(tmp_path)
    from dreamfusion_torch.utils.backend import KubernetesBackend

    be = KubernetesBackend(root=str(tmp_path / "jobs"))
    rc = be.submit("dreamfusion_torch.utils.backend:_test_job_entry",
                   {"x": 21})
    assert rc == 1


def test_kube_params_yaml_roundtrips_scalar_types(fake_kubectl, tmp_path,
                                                  monkeypatch):
    """Kube jobs receive the same typed params a local pickle delivers:
    0.001 stays a float through the parameters file (JSON in the port)."""
    import glob

    kubectl, fake_dir = fake_kubectl
    (fake_dir / "scenario_0.log").write_text("trained\n")
    monkeypatch.setenv("DFTPU_KUBECTL", kubectl)
    monkeypatch.setenv("DFTPU_KUBE_NAMESPACE", "ns")
    monkeypatch.chdir(tmp_path)
    from dreamfusion_torch.utils.backend import KubernetesBackend, LocalBackend

    be = KubernetesBackend(root=str(tmp_path / "jobs"))
    rc = be.submit("dreamfusion_torch.utils.backend:_test_job_entry",
                   {"lr": 0.001, "steps": 10, "name": "run-a",
                    "weird": object()})
    assert rc == 0
    [pfile] = glob.glob(str(tmp_path / "jobs" / "*" /
                            "kube_job_parameters.yaml"))
    monkeypatch.setenv("DFTPU_PARAMS_FILE", pfile)
    got = LocalBackend.load_parameters()
    assert got["lr"] == 0.001 and isinstance(got["lr"], float)
    assert got["steps"] == 10 and isinstance(got["steps"], int)
    assert got["name"] == "run-a"
    assert isinstance(got["weird"], str)       # repr fallback


def test_kube_params_arrive_as_the_jax_package_delivers_them(
        fake_kubectl, tmp_path, monkeypatch):
    """The same parameters through both packages' KubernetesBackend and
    load_parameters (the JAX package's file is YAML, the port's JSON):
    scalars, strings, lists and dicts arrive as themselves (a tuple as a
    list), what yaml.safe_dump refuses (a numpy scalar, an OrderedDict, an
    object) as its repr. The exec'd command imports the port only."""
    import collections
    import glob

    from dreamfusion_tpu.utils import backend as jb
    from dreamfusion_torch.utils import backend as tb

    kubectl, fake_dir = fake_kubectl
    for i in range(2):
        (fake_dir / f"scenario_{i}.log").write_text("trained\n")
    monkeypatch.setenv("DFTPU_KUBECTL", kubectl)
    monkeypatch.setenv("DFTPU_KUBE_NAMESPACE", "ns")
    monkeypatch.chdir(tmp_path)
    thing = object()
    params = {"lr": 0.001, "steps": 10, "name": "run-a", "flag": True,
              "none": None, "nested": [1, [2.5, "a"]],
              "cfg": {"a": [1, 2], "b": None, "c": {"d": 1e-8}},
              "pair": (1, 2), "f32": np.float32(1.5), "i64": np.int64(7),
              "in_list": [1, (2, 3)], "weird": thing, "big": 2 ** 40,
              "ordered": collections.OrderedDict(a=1), "np_bool": np.bool_(1)}
    got = {}
    for name, mod in (("jax", jb), ("port", tb)):
        root = tmp_path / name
        assert mod.KubernetesBackend(root=str(root)).submit(
            "dreamfusion_torch.utils.backend:_test_job_entry", params) == 0
        [pfile] = glob.glob(str(root / "*" / "kube_job_parameters.yaml"))
        monkeypatch.setenv("DFTPU_PARAMS_FILE", pfile)
        got[name] = mod.LocalBackend.load_parameters()
    assert got["port"] == got["jax"]
    for k in ("lr", "steps", "flag", "nested", "cfg", "big"):
        assert got["port"][k] == params[k]
        assert type(got["port"][k]) is type(params[k]), k
    assert got["port"]["pair"] == [1, 2]
    assert got["port"]["in_list"] == [1, [2, 3]]
    for k in ("f32", "i64", "weird", "ordered", "np_bool"):
        assert got["port"][k] == repr(params[k]), k
    # (the fake logs its calls with echo, which reads the leading "-n" of
    # "-n <namespace>" as its own flag: the log is one line)
    jax_code, port_code = re.findall(r"python -c '([^']*)'",
                                     (fake_dir / "calls.log").read_text())
    assert "from dreamfusion_tpu.utils import backend" in jax_code
    assert port_code == tb.job_code(
        "dreamfusion_torch.utils.backend:_test_job_entry")
    assert "dreamfusion_tpu" not in port_code
