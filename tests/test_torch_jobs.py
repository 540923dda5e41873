"""The port's job layer (dreamfusion_torch/utils/, training/jobs.py,
examples/edit_scene.py) against the JAX package's, on the CPU.

- The cases of tests/test_utils_backend.py on the port's tools and
  LocalBackend; differences written down: parse_params names the port's
  data parallelism ("data_parallel") where the JAX package names its
  shard_map, get_model_weight_hash hashes a state dict, and pick_devices
  picks CUDA devices;
- the code LocalBackend.submit launches imports the port;
- train_model on a tiny Blender-layout scene with device="cpu", once as a
  job through LocalBackend.submit (params.json, metrics.jsonl with
  test/psnr, the weight-hash line, the .dvgo artifact) and once in this
  process: the same seed gives the same weight hash;
- results: load_job, get_targets, results_extract, copy_models, gather_tb
  and mean_results on those job directories;
- edit_scene: the same argv builds the same Config values in both
  packages (each package's Trainer stubbed).
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from dreamfusion_tpu.utils import parse_params as j_parse_params
from dreamfusion_tpu.utils import random_params as j_random_params

from dreamfusion_torch.utils import (backend, get_model_weight_hash,
                                     parse_params, random_params,
                                     skip_if_excuted, submit_jobs)
from dreamfusion_torch.utils import results
from dreamfusion_torch.utils.backend import LocalBackend

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_random_params_grammar_matches_jax():
    spec = {"lr": [1e-3, 1e-4], "arch": ("a", ["b", "c"]),
            "layers_no_choice": [1, 2, 3], "fixed": 5,
            "n": [np.int64(3), np.float32(0.5)], "deep": {"x": [[1, 2], [3]]}}
    for seed in range(6):
        np.random.seed(seed)
        out = random_params(spec)
        np.random.seed(seed)
        assert out == j_random_params(spec)
    assert out["layers"] == [1, 2, 3] and out["fixed"] == 5
    assert out["arch"][0] == "a" and out["arch"][1] in ("b", "c")


def test_parse_params_aliases_and_the_dp_backend():
    for p in ({"lr": 0.01, "dataset": "nerf", "devices": 4},
              {"max_lr": 3.0, "dataset": {"name": "nerf",
                                          "total_batch_size": 64},
               "devices": 4},
              {"dataset": {"batch_size": 8}, "devices": 2},
              {"learning_rate": 1e-3}):
        got, want = parse_params(dict(p)), j_parse_params(dict(p))
        # the one difference: the multi-device backend's name
        if want["backend"] == "shard_map":
            assert got.pop("backend") == "data_parallel"
            want.pop("backend")
        assert got == want
    p = parse_params({"lr": 0.01, "devices": 1})
    assert p["backend"] is None and p["learning_rate"] == p["max_lr"] == 0.01


def test_weight_hash_of_state_dicts():
    m = torch.nn.Linear(3, 2)
    h1 = get_model_weight_hash(m)
    assert h1 == get_model_weight_hash(
        {k: v.clone() for k, v in m.state_dict().items()})
    assert h1 == get_model_weight_hash(
        {"weight": m.weight.detach().numpy(), "bias": m.bias.detach().numpy()})
    with torch.no_grad():
        m.bias[0] += 1.0
    assert get_model_weight_hash(m) != h1
    nested = {"a": np.arange(5.0), "b": {"c": torch.ones(2, 2,
                                                         dtype=torch.bfloat16)}}
    assert get_model_weight_hash(nested) == get_model_weight_hash(
        {"b": {"c": torch.ones(2, 2, dtype=torch.bfloat16)},
         "a": np.arange(5.0)})


def test_skip_if_excuted():
    calls = []

    @skip_if_excuted
    def f(x):
        calls.append(x)
        return x * 2

    assert f(3) == 6 and f(3) == 6 and calls == [3]
    assert f(4) == 8 and calls == [3, 4]


def test_submit_jobs_dedupes():
    class FakeBackend:
        def __init__(self):
            self.jobs = []

        def submit(self, cmd, params):
            self.jobs.append((cmd, params))

        def log(self, *a):
            pass

    np.random.seed(0)
    be = FakeBackend()
    submit_jobs(lambda: {"lr": [11, 12, 13]}, "mod:fn", number_jobs=3,
                backend=be)
    assert sorted(p["lr"] for _, p in be.jobs) == [11, 12, 13]
    assert all(c == "mod:fn" and p["seed"] == 2018011328 for c, p in be.jobs)


def test_local_backend_runs_the_port(tmp_path, monkeypatch):
    """The job subprocess imports the port's module and the port's
    backend, never the JAX package; _test_job_entry doubles x."""
    monkeypatch.chdir(tmp_path)
    code = backend.job_code("dreamfusion_torch.utils.backend:_test_job_entry")
    assert "dreamfusion_tpu" not in code
    assert code.startswith("import dreamfusion_torch.utils.backend; "
                           "from dreamfusion_torch.utils import backend;")
    be = LocalBackend(root=str(tmp_path / "jobs"))
    assert be.submit("dreamfusion_torch.utils.backend:_test_job_entry",
                     {"x": 21}) == 0
    [job] = [results.load_job(str(d)) for d in (tmp_path / "jobs").iterdir()]
    assert job["metrics"] == {"result": [42.0]}


def test_pick_devices_is_positional_over_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for GPU-less hosts")
    assert results.pick_devices(0) == []
    with pytest.raises(RuntimeError, match="need 1 devices, have 0"):
        results.pick_devices(1)


def _ball_scene(root):
    sys.path.insert(0, str(ROOT))
    from chip_smoke import write_ball_scene

    write_ball_scene(str(root), n_train=6, n_val=1, n_test=2, size=16)


def _tiny_params(scene, save_name):
    from dreamfusion_torch.training.jobs import params_for_nerf

    p = params_for_nerf(str(scene), save_name=str(save_name))
    p.update(batch_size=256, device="cpu", max_test_batches=1, seed=3,
             coarse_model={"num_voxels": 12 ** 3, "alpha_init": 1e-2})
    p["coarse_train"].update(n_iters=8)
    p["fine_model"].update(num_voxels=14 ** 3, k0_dim=4, rgbnet_width=16,
                           posbase_pe=2, viewbase_pe=2, bbox_thres=1e-4,
                           alpha_init=1e-2)
    p["fine_train"].update(n_iters=3, pg_scale=())
    return p


def test_train_model_job_and_its_weight_hash(tmp_path, monkeypatch, capfd):
    from dreamfusion_torch.training.jobs import train_model

    monkeypatch.chdir(tmp_path)
    _ball_scene(tmp_path / "ball")
    be = LocalBackend(root=str(tmp_path / "jobs"))
    rc = be.submit("dreamfusion_torch.training.jobs:train_model",
                   _tiny_params(tmp_path / "ball", tmp_path / "a.dvgo"))
    out = capfd.readouterr().out
    assert rc == 0, out
    [job_dir] = list((tmp_path / "jobs").iterdir())
    names = sorted(os.listdir(job_dir))
    assert names == ["a.dvgo", "metrics.jsonl", "params.json", "params.pkl"]
    job = results.load_job(str(job_dir))
    assert np.isfinite(job["metrics"]["test/psnr"][-1])
    assert job["params"]["device"] == "'cpu'"
    [hash_a] = [ln.split()[-1] for ln in out.splitlines()
                if "model weight hash:" in ln]

    # the same parameters again, in this process
    monkeypatch.setenv("DFTPU_JOB_DIR", str(tmp_path / "again"))
    psnr = train_model(_tiny_params(tmp_path / "ball", tmp_path / "b.dvgo"))
    [hash_b] = [ln.split()[-1] for ln in capfd.readouterr().out.splitlines()
                if "model weight hash:" in ln]
    assert hash_a == hash_b and len(hash_a) == 64
    assert psnr == job["metrics"]["test/psnr"][-1]

    # the result tools over the two job directories
    root = str(tmp_path)
    rows = results.results_extract(root)
    assert len(rows) == 2 and rows[0]["test/psnr"] == psnr
    assert len(results.get_targets(root, {"seed": 3})) == 2
    assert results.get_targets(root, {"seed": 4}) == []
    assert results.mean_results(root, "test/psnr") == pytest.approx(psnr)
    copied = results.copy_models(root, str(tmp_path / "best"))
    assert len(copied) == 2 and all(c.endswith(".dvgo") for c in copied)
    LocalBackend().set_tensorboard_logdir(str(tmp_path / "best"))
    links = results.gather_tb(root, str(tmp_path / "tb"))
    assert [os.path.realpath(ln) for ln in links] == [
        os.path.realpath(tmp_path / "best")]


def _load_jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_edit_scene", ROOT / "examples" / "edit_scene.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_edit_scene_builds_the_jax_config(monkeypatch, tmp_path):
    from dreamfusion_torch.examples import edit_scene

    seen = {}

    class StubTrainer:
        def __init__(self, name, cfg):
            seen.setdefault("cfgs", []).append(cfg)
            seen.setdefault("calls", []).append(("init", name))

        def train(self, max_steps):
            seen["calls"].append(("train", max_steps))

        def test(self, size):
            seen["calls"].append(("test", size))

        def save_mesh(self, resolution):
            seen["calls"].append(("save_mesh", resolution))

    jmod = _load_jax_example()
    monkeypatch.setattr(jmod, "Trainer", StubTrainer)
    monkeypatch.setattr(edit_scene, "Trainer", StubTrainer)
    for argv in (["--pretrained_dvgo", "s.dvgo"],
                 ["--pretrained_dvgo", "s.dvgo", "--text", "a red ficus",
                  "--iters", "3", "--workspace", str(tmp_path), "--guidance",
                  "none", "--sd_weights", "random-tiny"]):
        seen.clear()
        jmod.main(argv)
        edit_scene.main(argv + ["--device", "cpu"])
        jcfg, tcfg = seen["cfgs"]
        j, t = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
        common = sorted(set(j) & set(t))
        assert len(common) > 60
        assert {k: t[k] for k in common} == {k: j[k] for k in common}
        assert t["device"] == "cpu"
        calls = seen["calls"]
        assert calls[:4] == calls[4:]
        assert calls[:4] == [("init", "edit"), ("train", jcfg.iters),
                             ("test", 36), ("save_mesh", 256)]


def test_edit_scene_docstring_names_the_port():
    from dreamfusion_torch.examples import edit_scene

    doc = edit_scene.__doc__
    assert "dreamfusion_torch.training.jobs import train_model" in doc
    assert "python -m dreamfusion_torch.examples.edit_scene" in doc
    assert "dreamfusion_tpu" not in doc.replace(
        "counterpart of\nexamples/edit_scene.py", "")


def test_params_json_round_trip_of_the_logged_params(tmp_path, monkeypatch):
    monkeypatch.setenv("DFTPU_JOB_DIR", str(tmp_path))
    be = LocalBackend(root=str(tmp_path))
    be.log_params({"lr": 0.5, "pg": (1, 2)})
    be.log_metric("psnr", np.float32(20.5))
    with open(tmp_path / "params.json") as f:
        assert json.load(f) == {"lr": "0.5", "pg": "(1, 2)"}
    assert results.load_job(str(tmp_path))["metrics"] == {"psnr": [20.5]}


def test_train_model_runs_on_the_gpu_unless_asked(tmp_path, monkeypatch):
    """Without params["device"] the job trains on the GPU, so on a GPU-less
    host it raises; torch's deterministic mode is restored either way."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for GPU-less hosts")
    from dreamfusion_torch.training.jobs import train_model

    from test_torch_purity import _tiny_scene

    monkeypatch.setenv("DFTPU_JOB_DIR", str(tmp_path))
    before = torch.are_deterministic_algorithms_enabled()
    with pytest.raises(RuntimeError, match="CUDA"):
        train_model({"cfg_data": None, "data_dict": _tiny_scene(),
                     "coarse_model": {"num_voxels": 64}})
    assert torch.are_deterministic_algorithms_enabled() == before
