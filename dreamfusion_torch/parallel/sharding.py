"""Data parallelism across processes (counterpart of
dreamfusion_tpu/parallel/sharding.py; reference DDP, nerf/utils.py:200-202,
and the eval all_gather, :787-797).

One process per rank, each on its own device (``cuda:r`` with NCCL, or the
CPU with gloo), joined by ``torch.distributed``. The caller names the
backend and the device of every rank; nothing here picks a backend.

- Training: every rank computes ``grads_fn`` with its own draws (the JAX
  package folds its key by the device index), then one flat all-reduce
  averages every trainable parameter's gradient (zeros where ``.grad`` is
  None: a parameter reached on one rank and not on another would otherwise
  leave the ranks in different collectives), the loss and every metric.
  Each rank then applies the same update, so the parameters stay the same
  bits everywhere. The K / M budgets come from the averaged metrics.
- Rendering: the rays are padded to a multiple of the world size (origin
  0, direction (1, 1, 1), sharding.py:70-74), each rank renders its slice
  and ``all_gather`` assembles the frame.

``spawn`` starts the ranks with the ``spawn`` start method, runs a job in
each and returns what each job returned. Collectives time out after
``timeout_s`` seconds, so a rank that dies or hangs fails the run. A gloo
group on CUDA tensors (several ranks on one card) stages each collective
through host memory.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclass
class DataParallel:
    """A rank's view of the process group: its rank, the world size, its
    device and the backend. ``stats`` gathers the gradient all-reduce's
    wall time and, apart, the wait for the slowest rank before it."""
    rank: int
    world_size: int
    device: torch.device
    backend: str
    stats: Dict[str, float] = field(default_factory=lambda: {
        "wait_s": 0.0, "allreduce_s": 0.0, "allreduces": 0})

    def _run(self, t: torch.Tensor, op) -> torch.Tensor:
        """op on t (in place), through host memory for gloo on CUDA."""
        if self.backend == "gloo" and t.is_cuda:
            host = t.cpu()
            op(host)
            t.copy_(host)
        else:
            op(t)
        return t

    def all_reduce_mean(self, t: torch.Tensor) -> torch.Tensor:
        self._run(t, dist.all_reduce)
        return t.div_(self.world_size)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """t takes rank src's values, in place (bool through a u8 view)."""
        self._run(t.view(torch.uint8) if t.dtype == torch.bool else t,
                  lambda x: dist.broadcast(x, src))
        return t

    def all_gather_cat(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t (same shape) concatenated along dim 0, in rank
        order."""
        t = t.contiguous()
        src = t.cpu() if self.backend == "gloo" and t.is_cuda else t
        parts = [torch.empty_like(src) for _ in range(self.world_size)]
        dist.all_gather(parts, src)
        return torch.cat(parts).to(t.device)


def world_size(n_devices: int, device: torch.device) -> int:
    """Ranks for cfg.n_devices on `device`: on the CPU n_devices gloo ranks
    (0 counts as 1); on CUDA n_devices cards, 0 meaning every visible card.
    More ranks than visible cards raise (trainer.py:998-1003)."""
    if n_devices < 0:
        raise ValueError(f"n_devices={n_devices} must be >= 0")
    if device.type == "cpu":
        return max(n_devices, 1)
    visible = torch.cuda.device_count()
    n = n_devices or max(visible, 1)
    if n > 1 and n > visible:
        raise ValueError(f"n_devices={n} but only {visible} CUDA devices "
                         "visible")
    return n


def data_parallel_grads(grads_fn: Callable, model: torch.nn.Module,
                        dp: DataParallel) -> Callable:
    """Wrap grads_fn(...) -> (loss, metrics), which leaves the gradients in
    the parameters' .grad, so that after it every rank holds the mean over
    the ranks of the gradients, the loss and the metrics (sharding.py:
    38-57). Each rank draws its own inputs; the caller gives it its own
    generators."""

    def wrapped(*args, **kw):
        loss, metrics = grads_fn(*args, **kw)
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        keys = sorted(metrics)
        scalars = torch.stack([torch.as_tensor(loss, dtype=torch.float32,
                                               device=dp.device)]
                              + [torch.as_tensor(metrics[k],
                                                 dtype=torch.float32,
                                                 device=dp.device).reshape(())
                                 for k in keys])
        flat = torch.cat([p.grad.reshape(-1).float() for p in params]
                         + [scalars])
        if dp.device.type == "cuda":
            torch.cuda.synchronize(dp.device)
        t0 = time.perf_counter()
        dist.barrier()              # the wait for the slowest rank, apart
        t1 = time.perf_counter()
        dp.stats["wait_s"] += t1 - t0
        dp.all_reduce_mean(flat)
        if dp.device.type == "cuda":
            torch.cuda.synchronize(dp.device)
        dp.stats["allreduce_s"] += time.perf_counter() - t1
        dp.stats["allreduces"] += 1
        off = 0
        for p in params:
            n = p.numel()
            p.grad.copy_(flat[off:off + n].view_as(p.grad))
            off += n
        vals = flat[off:]
        return vals[0], {k: vals[i + 1] for i, k in enumerate(keys)}

    return wrapped


def broadcast_module(module: torch.nn.Module, dp: DataParallel,
                     src: int = 0) -> None:
    """Every parameter and buffer of module takes rank src's values."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dp.broadcast(t.data, src)


def shard_rays_render(render_fn: Callable, dp: DataParallel) -> Callable:
    """Wrap render_fn(rays_o, rays_d) -> {name: [n, ...]} into a
    ray-sharded render of the whole frame: the rays padded to a multiple
    of the world size (origin 0, direction (1, 1, 1)), rank r renders the
    r-th slice, all_gather assembles the outputs (sharding.py:60-91)."""
    n = dp.world_size

    def wrapped(rays_o: torch.Tensor, rays_d: torch.Tensor):
        N = rays_o.shape[0]
        pad = (-N) % n
        if pad:
            rays_o = torch.cat([rays_o, rays_o.new_zeros(pad, 3)])
            rays_d = torch.cat([rays_d, rays_d.new_ones(pad, 3)])
        per = (N + pad) // n
        sl = slice(dp.rank * per, (dp.rank + 1) * per)
        out = render_fn(rays_o[sl], rays_d[sl])
        return {k: dp.all_gather_cat(v)[:N] for k, v in out.items()}

    return wrapped


def _rank_entry(rank: int, world: int, backend: str, device: str,
                init_method: str, timeout_s: float, job: Callable, args,
                out_dir: str) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:                       # the CPU's cores shared among the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = job(DataParallel(rank, world, dev, backend), *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(job: Callable, args: Sequence, devices: Sequence, backend: str,
          init_method: Optional[str] = None, timeout_s: float = 60.0,
          join_timeout_s: float = 3600.0) -> List:
    """Run job(dp, *args) in one process per entry of devices (rank r on
    devices[r]) and return each rank's result, in rank order. job must be a
    module-level function (the ranks import it). init_method defaults to a
    file in a fresh directory, so no TCP port is taken. A rank that fails
    or outlives join_timeout_s fails the call (the others are stopped)."""
    ctx = torch.multiprocessing.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="df_ranks_")
    init_method = init_method or f"file://{os.path.join(out_dir, 'pg')}"
    world = len(devices)
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, world, backend, str(devices[r]),
                               init_method, timeout_s, job, tuple(args),
                               out_dir))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + join_timeout_s
        failed = []
        while time.monotonic() < deadline:
            failed = [(r, p.exitcode) for r, p in enumerate(procs)
                      if not p.is_alive() and p.exitcode != 0]
            if failed or not any(p.is_alive() for p in procs):
                break
            time.sleep(0.1)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung or failed:
            raise RuntimeError(f"data-parallel run failed: ranks still "
                               f"running after {join_timeout_s} s: {hung}; "
                               f"ranks that exited non-zero: {failed}")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(out_dir, ignore_errors=True)
