#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (dreamfusion_torch) on one GPU.

    python3 chip_smoke.py                 # default phases (what the check runs)
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,hashgrid,edit,kernels
    python3 chip_smoke.py --phases build,train,eval,kernels,profile
    python3 chip_smoke.py --phases build,o2,kernels      # path A only
    python3 chip_smoke.py --phases build,options,dp,kernels   # slice 9
    python3 chip_smoke.py --phases build,txt2img,export,gui,kernels  # slice 10
    python3 chip_smoke.py --phases build,pretrain,sd_dir     # slice 11
    python3 chip_smoke.py --phases build,zoo,jobs            # slice 12

Phases:
  build    compile every CUDA kernel of the main path from
           dreamfusion_torch/csrc with nvcc (sm_90a), one process per source,
           and beside them the mesh export's host library (g++);
  small    one small -O train step (SD random-nano, f32) on the GPU against
           the same step on the CPU's plain PyTorch path, with the same
           weights and draws, in four variants (lambertian with FD normals,
           the same with T_thresh = 0, albedo, the compositor in f64), and
           one small -O2 step on the stratified renderer in two (the grid
           field with FD normals, the vanilla field with autograd normals),
           each beside CPU control steps whose camera draws move by 2^-24
           (the -O2 ones take the GPU step's importance samples, and the
           grid one also controls with its density MLP's outputs moved by
           2^-23, see phase_small); the grid field's GPU step must launch
           kernel A once per field query (1 albedo, 7 shaded);
  train    the main path: `-O` training through the Trainer, grid NeRF with
           the full 16-level table, 64x64 renders, SDS on randomly
           initialised SD-v1.5-sized UNet and VAE, ~20 steps crossing the
           occupancy refreshes at steps 0 and 16; every launch count is set
           to 0 just before and read just after;
  eval     the second path, on the trained trainer: the staged 800x800
           eval (Trainer._render_orbit_frame, as Trainer.evaluate and
           Trainer.test render), one warm frame and 3 orbit frames with the
           launch counts set to 0 just before and read just after; frames/s
           and the synced wall of each stage over the same 3 frames; frame
           1 once more to capture the inputs of kernels C and D (kernel C
           must launch once per compact group), and that staged frame held
           against a direct full-K render_grid of the same pose (4,096-ray
           chunks): the f32 table, with the live cut and without, to rtol
           1e-4 / atol 1e-5, the default bf16 view to 5e-2 / 2e-2; then
           frame 1 under torch.profiler for its device launches and time;
  hashgrid the hash grid encoder through get_encoder("hashgrid") at its
           default spec (16 levels, 2 features, base 16, scale 2, 2^19 rows
           a level: 7,131,240 rows) on 524,288 points, the -O dense step's
           sample count, uniform in a box 5% wider than the encoder's so a
           share lies outside: three Adam steps of the table on a
           sum-of-squares loss to a fixed target (finite, falling, zeros
           outside the box), and the phase's peak device memory; kernel E
           launches once per backward, kernel A never;
  edit     the single-scene editing path: a .dvgo checkpoint at the width
           of a DVGO fine model (160^3 grids, 12 feature channels, a
           128 x 3 residual colour MLP, PE 5 / 4; a noisy ball of density)
           is written from the seed, then `-O --backbone dvgo --bg_radius
           0` trains 10 steps through the Trainer at 64x64 with SDS on the
           SD-v1.5-sized models (the train phase's guidance object when
           that phase ran), 5 albedo steps and 5 shaded with autograd
           normals; the grids must stay bitwise frozen and the colour MLP
           must move; then one 800x800 staged eval frame of that field
           (kernel C once per compact group; its device launches under
           torch.profiler) against a direct full-K render_grid of the same
           pose (rtol 1e-4 / atol 1e-5, with the live cut and without);
           then the same
           frame check on a steeper ball (edge half as wide, twice the
           noise, loaded into a second Trainer and given one occupancy
           refresh): live cut off to 1e-4 / 1e-5, the default live cut to
           atol 2e-4, its pixels outside 1e-4 / 1e-5 printed;
  o2       path A: (a) `-O2` training through the Trainer, the grid field
           at full width, 64x64 renders with 64 + 64 samples a ray, SDS on
           the SD-v1.5-sized models (the train phase's guidance object when
           that phase ran), 10 steps with --albedo_iters 5: steps/s after 2
           warm-up steps, peak memory, and kernel A once per field query in
           a backward, the flash kernels launched, parameters moved; (b) an
           800x800 orbit frame through Trainer._render_orbit_frame (157
           chunks of 4,096 rays), its wall, and one chunk of it against the
           CPU plain path from a copy of the state (as trained, bf16 MLPs:
           5e-2 / 2e-2, its pixels outside 1e-4 / 1e-5 printed; both copies
           in f32: 1e-4 / 1e-5); (c) BASELINE config 1 at full width, the
           vanilla field (5 x 128 ResMLP) with CLIP random-tiny, 5 steps
           with --albedo_iters 2 (autograd normals and their second-order
           term at 524,288 samples): finite losses, steps/s and peak memory;
           it launches no hand-written kernel; small also holds one Shampoo
           update on the card against the CPU (small_shampoo);
  options  the train options at full width (grid field, SD random-full,
           64x64): (a) -O --dt_gamma 1/128 --jitter_pose --ema_decay 0.95,
           10 steps: kernel F exactly once a step, A, B and K5 launched, the
           EMA equal to its chain recomputed after each step, then an
           800x800 orbit frame through the staged eval's march-everything
           fallback (F once per 4,096-ray group, B-fwd once per group with
           an emit; its device launches under torch.profiler) against a
           direct full-K render_grid (f32 table 1e-4 / 1e-5, the default
           bf16 view 5e-2 / 2e-2); (b) -O --optimizer shampoo, 12 steps
           (refreshes at counts 1 and 10): steps/s, the refresh steps'
           walls, peak memory, finite losses, parameters moved;
  dp       two data-parallel ranks on the one card (gloo; parallel/jobs.py
           train_job through sharding.spawn), full-width -O with SD
           random-full, 3 steps: the first step's averaged gradients equal
           the mean of the ranks' own, parameters and grid the same bits on
           both ranks after every step, a ray-sharded 800x800 frame equal
           to rank 0's direct render_grid (1e-6); steps/s and the
           all-reduce's time;
  txt2img  the txt2img pipeline (guidance/sd/pipeline.prompt_to_img) at SD
           v1.5 widths (random-full, bf16; the train phase's guidance
           object, or one built for the slice-10 phases), 512x512, CFG 7.5: plms 50 steps,
           pndm 6 (its 3 PRK transfers make 4 UNet evaluations each), ddim
           10: ms per UNet evaluation and per decode (CUDA events), K5
           launches in the UNet and in the decoder's mid block, peak
           memory, the image finite and uint8; the last decode again with
           the plain attention path on the card (3e-2 of its largest
           entry), and its mid-block attention output alone against f32
           scores and softmax (3x the plain bf16 path's error);
  export   path (a), `--test --save_mesh` on the train phase's trainer
           (without that phase, a new one trained 8 steps): 2
           orbit frames, then Trainer.save_mesh(256) with the 1024^2
           texture: the threshold, vertices and faces, the seconds of the
           density query, iso-surface, bake and write, the OBJ parsed back;
           sigma at 65,536 lattice points against the CPU copy of the field
           (bf16 MLPs 5e-2 / 2e-2, both in f32 1e-4 / 1e-5);
  gui      path (c), apps/gui.NeRFGUICore with no display over a new
           full-width -O trainer: 3 train bursts (adaptive size), preview
           frames (albedo, lambertian, a still view accumulating a second
           sample; adaptive resolution, so frames such as 357x357 that pad
           the eval's last group), reset_weights, one more burst and
           preview; burst sizes and ms, preview sizes, ms and spp;
  pretrain DVGO pretraining (training/nerf_pipeline.train_nerf_models) at
           the published DVGO Blender widths (coarse 1,024,000 voxels, k0
           3; fine 160^3, k0 12, a 128 x 3 ResMLP, PE 5 / 4; 8,192 rays a
           step) on an analytic ball coloured by its normal, written in the
           Blender layout (100 train, 4 val, 4 test views of 400x400, near 2
           far 6, cameras at radius 4) as PNGs by write_png and read back by
           load_data; cut in depth to 300 coarse iterations from 512,000
           voxels with one pg_scale milestone (scale_volume_grid) and 300
           fine (a fine step takes ~0.48 s, PERF.md): steps/s of each
           stage, peak memory, the test PSNR of the untrained and the
           trained fine field (the pipeline's mean of batch PSNRs, and of
           the pooled error; trained >= untrained + 5 dB in both), one
           fine step under torch.profiler, the .dvgo write and
           read walls; the .dvgo into DVGOEditNetwork (sigma and albedo at
           65,536 points equal the fine field's, atol 1e-6), 3 editing steps
           (-O --backbone dvgo --bg_radius 0, SD random-full: B and K5), and
           an 800x800 ImageRenderer frame against the analytic scene; the
           pretraining itself launches kernel G (grid_sample_3d) and no
           other hand-written kernel (cumprod compositing);
  sd_dir   a whole SD directory at SD v1.5 widths found by the probe: the
           random-full UNet and VAE in float16 safetensors under diffusers
           names (~1.7 GB), a random ViT-L/14-width text encoder and a
           synthetic BPE tokenizer, written in a temporary directory;
           $SD_WEIGHTS_DIR set for the phase only; build_guidance with
           sd_weights None must pick it; every loaded tensor equal to the
           file after the compute dtype's cast, ids and text embeddings of
           two prompts equal to the CPU path (rtol 1e-5), one UNet eps
           against the source module; 5 SDS steps of -O on it; the load
           wall, text-encode ms and steps/s; the directory deleted;
  zoo      the DVGO model zoo and the OSR fields (models/zoo.py,
           models/osr.py), the 12 classes of the registry beyond the base,
           each at DVGO fine width (160^3 grids in a +-1.1 box, k0 12, a
           128 x 3 decoder of the kind the JAX package's tests give it, PE
           5 / 4, stepsize 0.5), its density the ball of the ball scene
           (written once for zoo and jobs, as for pretrain): 5 DVGOTrainer
           steps of 8,192 rays (finite losses, every parameter moved, env
           too; steps/s after 2, peak memory, one step's device time by
           kernel), 64 rays on the card against the CPU copy with the same
           draws (rtol 1e-4 / atol 1e-5; OSR_Fine and V2, whose normal
           steers, within 3x a CPU control with the ray origins moved an
           ulp either way, and their normal on the same positions to
           1e-4 / 1e-5), one OSR_Fine evaluate batch under no_grad;
           kernel G and no other kernel on this path (the normals keep the
           written-out gather);
  jobs     the job layer: LocalBackend.submit of
           dreamfusion_torch.training.jobs:train_model(params_for_nerf(<the
           ball scene>)) as a subprocess on the card, at the widths of
           nerf_pipeline.DEFAULTS, cut in depth to 500 coarse iterations
           (fewer leave the fine box short of the ball) and 100 fine (the
           mesh needs trained densities); its job directory checked
           (params.json, test/psnr in
           metrics.jsonl, the weight-hash line, the .dvgo); then
           `python -m dreamfusion_torch.examples.edit_scene` on that .dvgo
           with --iters 3, as the example is written (36 orbit frames at
           800x800, save_mesh(256)): each part's wall and its launches;
  kernels  each kernel against its plain PyTorch version on the card at the
           main paths' shapes (grid-encoder scatter at the dense and the
           compacted steps' sample counts and all 16 level sizes, plus a
           4,096-row level, and at the -O2 step's 524,288 samples, all
           inside the box, each an entry of the kernels line, with the
           mean distinct rows per 32-sample warp at each level; the hash
           grid's scatter, which forms its rows from the unit positions, at
           the hashgrid phase's inputs and at a 4-level spec; the
           compositor at N = 4,096 rays with every K of the trainer's ladder
           up to grid_K, timed at the main path's K by device time, and
           B-bwd's mask against B-fwd's on 4,096 rays that cross T_thresh
           within rounding; flash attention at the UNet's
           and the VAE's 4,096-token self-attention, the VAE's with its
           backward (each shape an entry of the kernels line, with its
           achieved TFLOP/s beside scaled_dot_product_attention's); the
           eval's compact compositor (kernel C) at every compact budget its
           groups used, against its plain version and against B-fwd on
           compact_expand of the same buffer (and of the crossing rays laid
           out compactly), and its probe gather at the frame's classify
           probes), and kernel F (the cone march, no Pallas counterpart)
           bitwise against its plain version at the train shape (4,096
           jittered, perturbed rays of the options phase's grid, max_steps
           512, K 128) and on a 4,096-ray eval chunk, and kernel G (the
           voxel-grid sampler, no Pallas counterpart) forward and backward,
           and its deterministic mode's ordered backward, at a pretraining
           step's shapes (the density at 8,192 x 954 samples of the ball
           scene's rays, ball_ring_rays, k0 at those inside the box),
           with times for
           kernel, plain version and, where one exists, one library call
           computing the same function (CUDA
           events; for the eval's two kernels, which take less time than
           the host needs to issue them, device time from torch.profiler;
           those two are checked only after the eval phase, at its inputs);
  profile  (not in the default run) torch.profiler over 3 more steps of
           the train phase's trainer, the edit phase's and the o2 phase's
           (-O2, grid field), and over the o2 phase's 800x800 frame (its
           ~400,000 events take the profiler minutes, and the windows
           after it lose events): device time
           per span and per kernel, busy share, and the device time of each
           of the port's own kernels (the eval and edit phases give the
           same for their frame).

Output: human-readable lines, then a {"kernels": [...]} JSON line, the
card's name and power limit from nvidia-smi, and last
{"ok": true, "device": {...}}. Any failure exits non-zero before the last
line. Without a CUDA device the script exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from dreamfusion_torch.ops import cuda as kcuda

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12         # float32 outside the tensor cores
H100_BF16_FLOPS = 989e12       # bf16 on the tensor cores, dense

# TPU kernels each CUDA kernel replaces (file:line of the pl.pallas_call)
REPLACES = {
    "grid_encoder_bwd": "dreamfusion_tpu/ops/pallas_scatter.py:560",
    "grid_encoder_bwd_rows": "dreamfusion_tpu/ops/pallas_scatter.py:108",
    "composite_fwd": "dreamfusion_tpu/ops/pallas_composite.py:153",
    "composite_bwd": "dreamfusion_tpu/ops/pallas_composite.py:201",
    # the stock Pallas TPU flash attention, reached from its flash branch
    "attention_fwd": "dreamfusion_tpu/guidance/sd/layers.py:130",
    "attention_bwd": "dreamfusion_tpu/guidance/sd/layers.py:130",
    # the one-hot scatter that dreamfusion_tpu/ops/marching.py::
    # composite_compact sums its per-ray rows with
    "composite_compact": "dreamfusion_tpu/ops/pallas_scatter.py:735",
    "probe_select_small": "dreamfusion_tpu/ops/pallas_probe.py:72",
    # no Pallas counterpart: the JAX package's lax.scan cone march
    "march_cone": "dreamfusion_tpu/ops/marching.py:248",
    # no Pallas counterpart: the JAX package's written-out gather
    "grid_sample_fwd": "dreamfusion_tpu/ops/grid_sample.py",
    "grid_sample_bwd": "dreamfusion_tpu/ops/grid_sample.py",
    # no Pallas counterpart: the JAX package's XLA take and blend
    "grid_encoder_fwd": "dreamfusion_tpu/ops/grid_encoder.py",
    # no Pallas counterpart: the JAX package's windowed march (XLA ops,
    # its sort-based compaction), one call per ray group
    "march_window": "dreamfusion_tpu/ops/marching.py:519",
}
# kernel A at a level of 4,096 rows stands in for K1b, matmul_scatter_add_oct
K1B_REPLACES = "dreamfusion_tpu/ops/pallas_scatter.py:645"
# kernel (launch_counts key) -> its source, from ops/cuda.py's table
SOURCES = {e.counter: f"dreamfusion_torch/csrc/{kcuda.SOURCES[e.library]}"
           for e in kcuda.ENTRIES.values() if e.counter is not None}
# the kernels of each path the script drives
TRAIN_KERNELS = ("grid_encoder_fwd", "grid_encoder_bwd", "composite_fwd",
                 "composite_bwd", "attention_fwd", "attention_bwd")
# (the eval's dense groups, those whose live count fills the K bucket,
# composite through kernel B-fwd)
EVAL_KERNELS = ("grid_encoder_fwd", "composite_compact", "probe_select_small",
                "composite_fwd", "march_window")
# the editing path trains a field without a grid-encoder table
EDIT_TRAIN_KERNELS = ("composite_fwd", "composite_bwd", "attention_fwd",
                      "attention_bwd")
EDIT_EVAL_KERNELS = ("composite_compact", "probe_select_small",
                     "march_window")
ENCODER_KERNELS = ("grid_encoder_fwd", "grid_encoder_bwd",
                   "grid_encoder_bwd_rows")
# DVGO's voxel grids (pretraining, the zoo, the editing field)
GRID_SAMPLE_KERNELS = ("grid_sample_fwd", "grid_sample_bwd")
# -O2 (path A) with the grid backbone: kernel A in the field's backward and
# the flash kernels through SDS; the compositor is plain on this path
O2_TRAIN_KERNELS = ("grid_encoder_fwd", "grid_encoder_bwd", "attention_fwd",
                    "attention_bwd")
HASHGRID_POINTS = 524_288          # 4,096 rays x K = 128 samples


def _recorded(fn):
    """fn() with dreamfusion_torch.trace's recorder on -> (what fn
    returned, {span name: host ms} of the spans it entered)."""
    from dreamfusion_torch import trace

    trace.reset()
    trace.enable()
    try:
        out = fn()
    finally:
        trace.disable()
    ms = {k: v["host_ns"] * 1e-6 for k, v in trace.table().items()
          if v["calls"]}
    trace.reset()
    return out, ms


def only_grid_sample(counts) -> bool:
    """Whether counts launched kernel G both ways and no other kernel."""
    return (min(counts.get(k, 0) for k in GRID_SAMPLE_KERNELS) > 0
            and not any(v for k, v in counts.items()
                        if k not in GRID_SAMPLE_KERNELS))


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_time_and_launches(fn, reps: int = 20, warmup: int = 3):
    """(device ms, device launches) of fn() per call: the time and the
    number of the kernels (and copies) it launches, from torch.profiler.
    For calls whose kernels take less time than the host needs to issue
    them, where CUDA events around a run of calls would time the host.

    A warm-up step of the profiler's schedule, whose events are dropped,
    runs the calls first. fn launches the same kernels on every call, so
    each kernel's events are a multiple of reps, and the port's kernels'
    events equal the launches its wrappers counted over the recorded calls
    (cuda.launch_counts). Where either fails the events were lost or
    duplicated, and the counts are printed. Each kernel's time is its mean
    over the events that arrived times its launches a call (its events
    over reps, rounded, at least 1); a session that saw no kernel is run
    again. Where three sessions saw no kernel, or none of the port's
    kernels where its wrappers counted launches, the profiler lost the
    call's events: the time is then queued_cuda_ms's and the launches a
    call are the counted ones (None where fn launches none of the port's
    kernels)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    sources = _own_kernels()
    for _ in range(3):
        got = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: got.append(p.key_averages()),
                     acc_events=True) as prof:
            for n in (warmup, reps):
                counted = sum(kcuda.launch_counts.values())
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        counted = sum(kcuda.launch_counts.values()) - counted
        ms = launches = own = 0
        uneven = []
        for e in (got[0] if got else ()):
            if str(e.device_type).endswith("CUDA") and e.count:
                own += e.count if _own_source(e.key, sources) else 0
                if e.count % reps:
                    uneven.append(f"{e.key[:60]} x{e.count}")
                per_call = max(1, round(e.count / reps))
                ms += getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0)) \
                    / e.count / 1e3 * per_call
                launches += per_call
        if uneven or own != counted:
            log(f"[profile] events lost or duplicated over {reps} calls: "
                f"the port's kernels {own} events for {counted} counted "
                f"launches; not a multiple of {reps}: "
                + ("; ".join(uneven) or "none"))
        if launches and (own or not counted):
            return ms, launches
    ms = queued_cuda_ms(fn, reps, warmup)
    launches = max(1, round(counted / reps)) if counted else None
    log(f"[profile] torch.profiler lost the call's kernels in 3 sessions: "
        f"{ms:.4f} ms a call by CUDA events behind a queued sleep, "
        f"{launches} counted launches a call")
    return ms, launches


def queued_cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over reps calls by CUDA events, with the
    stream held by a sleep kernel while the host issues the calls, so that
    the events time the device and not the host's launch rate (fn must not
    synchronize)."""
    import time

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / warmup
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # about 2e6 cycles a millisecond at the card's clock: twice the host's
    # issue time of the reps calls, and at least 5 ms
    torch.cuda._sleep(int(2e6 * max(5.0, 2 * host_ms * reps)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of fn() per call (device_time_and_launches)."""
    return device_time_and_launches(fn, reps, warmup)[0]


def bound(nbytes: float, flops: float, peak: float = H100_F32_FLOPS):
    t_b = nbytes / H100_BYTES_PER_S * 1e3
    t_f = flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# -- phases ---------------------------------------------------------------------

def phase_build():
    t0 = time.perf_counter()
    secs = kcuda.build()
    log(f"[build] nvcc {kcuda.NVCC_FLAGS}, {os.environ.get('CXX', 'g++')} "
        f"{kcuda.CXX_FLAGS} -> {kcuda.BUILD_DIR}")
    for name, s in secs.items():
        log(f"[build] {name}: {s:.1f} s")
        for line in kcuda.build_log.get(name, "").splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] all kernels built in {time.perf_counter() - t0:.1f} s")


def _small_cfg():
    from dreamfusion_torch.config import Config

    return Config(text="a red cube", guidance="stable-diffusion",
                  sd_weights="random-nano", grid_ray=True, dir_text=True,
                  fp16=False, h=32, w=32, grid_size=32, max_steps=128,
                  grid_K=64, albedo_iters=0, lambda_orient=1e-2, iters=100)


# -O2's stratified renderer at the small size (32 + 32 samples a ray)
_SMALL_O2 = dict(grid_ray=False, num_steps=32, upsample_steps=32)
# (label, shading draw, T_thresh, compositor in f64 on both sides, config
# changes): the main path's lambertian step with its finite-difference
# normals, the same without the transmittance mask, an albedo step without
# normals or orientation loss, the lambertian step with the compositor
# computed in float64 (its plain formulas) on both devices; then -O2's
# lambertian step on the stratified renderer, with the grid field (FD
# normals) and with the vanilla field (autograd normals, whose second-order
# term reaches the parameters)
SMALL_VARIANTS = (("lambertian", 0.3, 1e-4, False, {}),
                  ("lambertian T_thresh=0", 0.3, 0.0, False, {}),
                  ("albedo, no normals", 0.9, 1e-4, False, {}),
                  ("lambertian, compositor in f64", 0.3, 1e-4, True, {}),
                  ("-O2 stratified, lambertian", 0.3, 1e-4, False, _SMALL_O2),
                  ("-O2 stratified, vanilla, lambertian", 0.3, 1e-4, False,
                   dict(_SMALL_O2, backbone="vanilla")))
# camera and marching draws that a control run changes by 2^-24
_CONTROL_DRAWS = ("radius", "u_sphere", "u_orbit", "perturb_u")


def _f64(fn):
    def run(*args):
        args = [a.double() if torch.is_tensor(a) else a for a in args]
        return tuple(x.float() for x in fn(*args))
    return run


def phase_small():
    """GPU step (kernels) against the CPU step (plain path) on the same
    weights and draws, at a small size in f32, in the SMALL_VARIANTS (the
    -O2 ones on the stratified renderer, which has no occupancy grid).

    Held tightly: the loss (1e-4 relative; by the rule of the gradients
    below), the occupancy grid (exact), the
    cotangent at the density MLP's output, which every part of the step
    from the field query through the compositor to the SDS loss feeds
    (1e-4 L2-relative), and the background MLP's and the density MLP's
    output bias gradients (1e-4 L2-relative). The hidden layers' and the
    table's gradients are held to 3x the largest change that CPU control
    runs show when the camera and marching draws change by 2^-24 (three
    draws of the signs), or 1e-4 where that is larger (the vanilla field's
    smooth MLP): at initialisation the grid MLP's pre-activations are
    ~1e-4 with zero biases, so rounding-sized moves of the sample positions
    flip a few ReLUs, and each flip moves these gradients by ~1e-2. On the
    stratified renderer the CPU steps take the GPU step's importance
    samples (sample_pdf's output follows the last bits of the coarse
    weights and of the cdf's cumsum, a parallel scan on the card), and
    sample_pdf is held against float64 on the GPU step's own inputs (3x
    the CPU's f32 error). The -O2 grid variant's finite-difference normals
    turn with an ulp of sigma there (its samples fill the box, where a
    young field's sigma is ~1 and nearly flat), so its leaves, the tight
    ones too, and its loss are held to 3x the larger of the draw controls
    and two CPU controls whose density-MLP outputs move by 2^-23 (or 1e-4
    where that is larger)."""
    from dreamfusion_torch.guidance.sd import layers
    from dreamfusion_torch.guidance.sd.sds import build_sd_guidance, sd_guidance
    from dreamfusion_torch.models.networks import build_model
    from dreamfusion_torch import renderer
    from dreamfusion_torch.ops import fused_composite as fc
    from dreamfusion_torch.ops import marching
    from dreamfusion_torch.training import trainer as tr

    cfg = _small_cfg()
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    m_cpu = build_model(cfg, cpu, gen)
    g_cpu = build_sd_guidance("random-nano", device=cpu, generator=gen)
    v_cpu = build_model(cfg.replace(backbone="vanilla"), cpu, gen)
    with torch.no_grad():       # a young field's thin density, as in tests/
        v_cpu.sigma_net.dense_out.bias[0] -= 4.0
    v_gpu = copy.deepcopy(v_cpu).to(gpu)
    m_gpu = copy.deepcopy(m_cpu).to(gpu)
    unet = copy.deepcopy(g_cpu.modules["unet"]).to(gpu)
    vae = copy.deepcopy(g_cpu.modules["vae"]).to(gpu)
    g_gpu = sd_guidance(unet, vae, g_cpu.modules["latent_size"])

    N = cfg.h * cfg.w
    rng = np.random.default_rng(0)
    jitter = torch.from_numpy(rng.uniform(size=(1, cfg.grid_size ** 3, 3))
                              .astype(np.float32))
    draws = {"radius": [1.2], "u_sphere": [[0.3, 0.6, 0.2]],
             "u_orbit": [[0.5, 0.25]], "u_select": [0.7], "fov": 50.0,
             "bg": rng.uniform(size=(N, 3)), "light_n": rng.normal(size=3),
             "perturb_u": rng.uniform(size=N),
             "vae_eps": rng.normal(size=(1, 32, 32, 4)), "t": [500],
             "noise": rng.normal(size=(1, 32, 32, 4))}
    tz = torch.from_numpy(rng.normal(size=(6, 2, 77, 16)).astype(np.float32))
    draws.update(o2_perturb_u=rng.uniform(size=(N, _SMALL_O2["num_steps"])),
                 pdf_u=rng.uniform(size=(N, _SMALL_O2["upsample_steps"])))

    def step(model, guid, dev, shade_u, T_thresh, c, f64, control=None,
             new_z=None, h_noise=None):
        """One step; on the stratified renderer new_z, when given, stands
        for sample_pdf's output, and the step's own sample_pdf inputs and
        output are returned. h_noise (a seed): 2^-23 s, s a random sign, is
        added to every output of the density MLP: sigma = exp(h + blob)
        moves by about an ulp, a control of what the last bits of the
        field (an exp of another library, say) do."""
        st = None
        if c.grid_ray:
            st = marching.init_grid_state(1, c.grid_size, dev)
            st = marching.update_grid(model.density, st, bound=1.0,
                                      density_thresh=10.0,
                                      jitter=jitter.to(dev))
        d = {k: torch.as_tensor(np.asarray(v)).float() for k, v in draws.items()}
        o2_u = d.pop("o2_perturb_u")
        if not c.grid_ray:
            d["perturb_u"] = o2_u
        if control is not None:
            g = torch.Generator().manual_seed(control)
            for k in _CONTROL_DRAWS:
                sign = torch.randint(0, 2, d[k].shape, generator=g) * 2 - 1
                d[k] = d[k] * (1 + 2.0 ** -24 * sign)
        d = {k: v.to(dev) for k, v in d.items()}
        d["t"] = d["t"].long()
        d["shade_u"] = shade_u
        g_out = []

        def keep_cotangent(module, inputs, out):
            if out.requires_grad:
                i = len(g_out)
                g_out.append(None)
                out.register_hook(lambda g: g_out.__setitem__(i, g.cpu()))

        sampled = {}
        pdf = renderer.sample_pdf

        def pdf_spy(bins, weights, n, det=False, u=None, generator=None):
            out = (pdf(bins, weights, n, det, u, generator) if new_z is None
                   else new_z.to(bins.device))
            sampled.update(z=out.cpu(), inputs=(
                bins.cpu(), weights.cpu(), n, det,
                None if u is None else u.cpu()))
            return out

        # fresh signs on every call: the +e and -e queries of a normal must
        # not move alike
        g_noise = torch.Generator().manual_seed(h_noise or 0)

        def jiggle(module, inputs, out):
            sign = torch.randint(0, 2, out.shape, generator=g_noise) * 2 - 1
            return out + 2.0 ** -23 * sign.to(out.device)

        hooks = [model.sigma_net.register_forward_hook(jiggle)
                 ] if h_noise is not None else []
        hook = model.sigma_net.register_forward_hook(keep_cotangent)
        render, cf, cb = tr.render_grid, fc.composite_fwd, fc.composite_bwd
        tr.render_grid = functools.partial(render, T_thresh=T_thresh)
        renderer.sample_pdf = pdf_spy
        if f64:
            fc.composite_fwd = _f64(fc.composite_fwd_plain)
            fc.composite_bwd = _f64(fc.composite_bwd_plain)
        try:
            fn = tr.make_grads_fn(c, model, guid, grid_K=c.grid_K,
                                  compact_M=N * 24)
            loss, met = fn(5, tz.to(dev), st, draws=d)
        finally:
            tr.render_grid, fc.composite_fwd, fc.composite_bwd = render, cf, cb
            renderer.sample_pdf = pdf
            for h in hooks + [hook]:
                h.remove()
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        grads["(cotangent at the density MLP output)"] = torch.cat(g_out)
        return (float(loss), grads, None if st is None else st.occ.cpu(),
                int(met.get("n_field_samples", N * (c.num_steps
                                                    + c.upsample_steps))),
                sampled)

    def l2(a, b):
        return {k: float((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30))
                for k in b}

    tight = ("(cotangent", "bg_net.", "sigma_net.dense_2.bias",
             "sigma_net.dense_out.bias")
    old_gn, old_tf32 = layers.GN_DTYPE, torch.backends.cudnn.allow_tf32
    layers.GN_DTYPE, torch.backends.cudnn.allow_tf32 = "f32", False
    failures = []
    try:
        for label, shade_u, T_thresh, f64, change in SMALL_VARIANTS:
            c = cfg.replace(**change)
            if shade_u >= 0.8:
                c = c.replace(lambda_orient=0.0)
            mc, mg = ((v_cpu, v_gpu) if c.backbone == "vanilla"
                      else (m_cpu, m_gpu))
            args = (shade_u, T_thresh, c, f64)
            counted = kcuda.launch_counts["grid_encoder_bwd"]
            lg, gg, og, _, zg = step(mg, g_gpu, gpu, *args)
            a_gpu = kcuda.launch_counts["grid_encoder_bwd"] - counted
            # the stratified renderer's importance samples follow the last
            # bits of the coarse weights and the order of the cdf's cumsum,
            # and the field's gradients at initialisation follow the
            # samples: the CPU steps take the GPU step's samples, and
            # sample_pdf itself is held against the CPU on its inputs
            z = zg.get("z")
            lc, gc, oc, n, _ = step(mc, g_cpu, cpu, *args, new_z=z)
            _, gg2, _, _, _ = step(mg, g_gpu, gpu, *args, new_z=z)
            ctrl = {k: 0.0 for k in gc}
            controls = [dict(control=seed) for seed in (0, 1, 2)]
            if z is not None and c.backbone == "grid":
                # the grid field's finite-difference normals divide sigma
                # differences by 2e-2; -O2's samples fill the whole box,
                # where at initialisation sigma is ~1 and its differences
                # over 2e-2 are ~1e-5, so an ulp of sigma (which the 2^-24
                # draw changes do not make) turns a normal by ~1%: CPU
                # steps whose density MLP outputs move by 2^-23 measure it
                controls += [dict(h_noise=seed) for seed in (0, 1)]
            loss_ctrls = []
            for kw in controls:
                lp, gp, _, _, _ = step(mc, g_cpu, cpu, *args, new_z=z, **kw)
                ctrl = {k: max(ctrl[k], v) for k, v in l2(gp, gc).items()}
                loss_ctrls.append(abs(lp - lc) / max(abs(lc), 1e-30))
            loss_ctrl = max(loss_ctrls)
            if z is not None:
                # held against float64 on the same inputs: where a bin's
                # cdf step is just above 1e-5 the sample moves ~1e5x the
                # cdf's rounding, so both f32 results stray alike
                b, w_, n_, det_, u_ = zg["inputs"]
                z64 = renderer.sample_pdf(b.double(), w_.double(), n_, det_,
                                          None if u_ is None else u_.double())
                e_gpu = float((z.double() - z64).abs().max())
                e_cpu = float((renderer.sample_pdf(*zg["inputs"]).double()
                               - z64).abs().max())
                z_tol = max(3 * e_cpu, 1e-6 * float(z.abs().max()))
                log(f"[small] {label}: sample_pdf on the GPU step's inputs "
                    f"({tuple(z.shape)}) against float64: GPU max_abs_err "
                    f"{e_gpu:.3e}, CPU {e_cpu:.3e} (tol {z_tol:.3e})")
                if not e_gpu <= z_tol:
                    failures.append(f"{label}: sample_pdf")
            gap, rerun = l2(gg, gc), l2(gg2, gg)
            loss_rel = abs(lg - lc) / max(abs(lc), 1e-30)
            occ_diff = 0 if oc is None else int((oc != og).sum())
            # the grid field's GPU step runs kernel A in its backward: once
            # for the field query plus six for the FD normals when shaded
            if c.backbone == "grid" and a_gpu != (7 if shade_u < 0.8 else 1):
                failures.append(f"{label}: kernel A launched {a_gpu} times")
            # the loss by the gradients' rule: 1e-4 where the variant has
            # only the draw controls, else 3x its controls' move, or 1e-4
            loss_tol = (1e-4 if len(controls) == 3
                        else max(3 * loss_ctrl, 1e-4))
            log(f"[small] {label}: loss cpu {lc:.6f} gpu {lg:.6f} rel "
                f"{loss_rel:.2e} (CPU controls " + ", ".join(
                    f"{next(iter(kw))} {x:.2e}"
                    for kw, x in zip(controls, loss_ctrls))
                + f"; tol {loss_tol:.2e}); occupancy cells differing "
                f"{occ_diff}; "
                f"field samples {n}; kernel A launches in the GPU step {a_gpu}")
            log(f"[small] {label}: L2-relative GPU-CPU / GPU rerun / CPU "
                f"control (draws changed by 2^-24): " + ", ".join(
                    f"{k} {gap[k]:.1e} {rerun[k]:.1e} {ctrl[k]:.1e}"
                    for k in gc))
            # the other leaves: 3x the control, and never below the tight
            # leaves' 1e-4 (the vanilla field's smooth SiLU MLP moves by
            # ~1e-6 under the control, as much as f32 rounding does)
            bad = [k for k in gc if not (
                gap[k] <= 1e-4 if k.startswith(tight) and len(controls) == 3
                else gap[k] <= max(3 * ctrl[k], 1e-4))]
            if occ_diff or not loss_rel <= loss_tol or bad:
                failures.append(f"{label}: {bad or 'loss/occupancy'}")
    finally:
        layers.GN_DTYPE, torch.backends.cudnn.allow_tf32 = old_gn, old_tf32
    if failures:
        raise AssertionError(
            "GPU step disagrees with the CPU plain path (tolerances: loss "
            "1e-4 rel or 3x its CPU control, occupancy exact, MLP-output cotangent and output-layer "
            "biases 1e-4 L2-relative, other gradients 3x the CPU control or "
            "1e-4): "
            + "; ".join(failures))


def phase_train(steps: int, warmup: int):
    from dreamfusion_torch.config import parse_config
    from dreamfusion_torch.training.trainer import Trainer

    ws = tempfile.mkdtemp(prefix="chip_smoke_ws_")
    argv = ["-O", "--text", "a hamburger", "--sd_weights", "random-full",
            "--iters", str(steps), "--albedo_iters", str(steps // 2),
            "--workspace", ws, "--ckpt", "scratch", "--seed", "0"]
    cfg = parse_config(argv)
    t0 = time.perf_counter()
    trainer = Trainer("smoke", cfg, use_checkpoint="scratch")
    torch.cuda.synchronize()
    n_sd = sum(p.numel() for m in ("unet", "vae")
               for p in trainer.guidance.modules[m].parameters())
    log(f"[train] python -m dreamfusion_torch.main {' '.join(argv)}")
    log(f"[train] setup {time.perf_counter() - t0:.1f} s; SD params {n_sd:,} "
        f"({next(trainer.guidance.modules['unet'].parameters()).dtype}); "
        f"grid table {trainer.model.embeddings.shape[0]:,} rows")

    rate, counts, losses, recs, peak = _train_timed(trainer, steps, warmup)
    log("[train] loss per step: " + " ".join(f"{float(x):.4g}" for x in losses))
    log("[train] (K, M) per step: " + " ".join(
        f"({r['grid_K']},{r['compact_M']})" for r in recs))
    log(f"[train] steps/s after warm-up: {rate:.4f} "
        f"(steps {warmup}..{steps}, includes the refresh at step 16)")
    log(f"[train] peak device memory: {peak:.2f} GiB")
    log(f"[train] kernels {json.dumps(counts)}")
    if not bool(torch.isfinite(losses).all()) or len(losses) != steps:
        raise AssertionError("non-finite loss in the train phase")
    if min(counts[k] for k in TRAIN_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {counts}")
    return trainer, counts


def small_shampoo():
    """One Shampoo update on the card against the same update on the CPU,
    at small width: a 4,152 x 2 table (32 blocks of 128 and a ragged one of
    56, at 10x LR), a 64 x 32 weight, a bias of 64 and a scalar, with the
    same seeded parameters and gradients. Each leaf's update is held to
    1e-4 of its largest entry, or to 3x the largest change that CPU control
    updates show when the gradients move by 2^-24 or 2^-23 (three sign
    patterns each), where that is larger: a table block's first statistics
    (rank 2 of 128) and a bias's (g g^T, rank 1) leave the f32 Newton
    iteration ill-conditioned (ROADMAP queue 3)."""
    from dreamfusion_torch.config import Config
    from dreamfusion_torch.training.optimizers import build_optimizer

    shapes = {"embeddings": (4152, 2), "w": (64, 32), "b": (64,), "s": ()}
    gen = torch.Generator().manual_seed(5)
    init = {k: torch.randn(v, generator=gen) * 0.1 for k, v in shapes.items()}
    grads = {k: torch.randn(v, generator=gen) for k, v in shapes.items()}
    cfg = Config(optimizer="shampoo", iters=100)

    def update(dev, rel=0.0, seed=0):
        m = torch.nn.ParameterDict({k: torch.nn.Parameter(v.clone().to(dev))
                                    for k, v in init.items()})
        opt, sched = build_optimizer(cfg, m)
        sg = torch.Generator().manual_seed(seed)
        for k, p in m.items():
            sign = torch.randint(0, 2, shapes[k], generator=sg) * 2.0 - 1.0
            p.grad = (grads[k] * (1 + rel * sign)).to(dev)
        opt.step()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return {k: (p.detach() - init[k].to(dev)).cpu() for k, p in m.items()}

    gpu, cpu = update(torch.device("cuda")), update(torch.device("cpu"))
    controls = [update(torch.device("cpu"), rel, seed)
                for rel in (2.0 ** -24, 2.0 ** -23) for seed in (1, 2, 3)]
    bad = []
    for k in shapes:
        gap = rel_err(gpu[k], cpu[k])
        ctl = max(rel_err(c[k], cpu[k]) for c in controls)
        tol = max(1e-4, 3 * ctl)
        log(f"[small] Shampoo update {k} {tuple(shapes[k])}: GPU-CPU "
            f"{gap:.2e} of the largest entry, CPU control {ctl:.2e}, "
            f"tolerance {tol:.2e}")
        if not gap <= tol:
            bad.append(k)
    if bad:
        raise AssertionError(f"Shampoo on the GPU disagrees with the CPU: "
                             f"{bad}")


def _options_argv(ws, steps, *extra):
    return ["-O", "--text", "a hamburger", "--sd_weights", "random-full",
            "--iters", str(steps), "--albedo_iters", str(steps // 2),
            "--workspace", ws, "--ckpt", "scratch", "--seed", "0", *extra]


def _stepwise(trainer, steps, each=None):
    """Train one step at a time (train() does the refreshes and budgets)
    with a sync after each: the per-step walls; each(trainer) after each
    step."""
    walls = []
    for s in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(max_steps=s + 1, log_interval=1,
                      checkpoint_at_end=False)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if each is not None:
            each(trainer)
    return walls


def _fallback_groups(trainer, o, d):
    """Groups of the fallback frame that have an emit (each shades through
    B-fwd once), from an independent march of the frame's padded rays."""
    from dreamfusion_torch.ops import marching
    from dreamfusion_torch.ops.composite import near_far_from_aabb

    cfg, g = trainer.cfg, trainer.cfg.max_ray_batch
    pad = (-o.shape[0]) % g
    o = torch.cat([o, o.new_zeros(pad, 3)])
    d = torch.cat([d, d.new_ones(pad, 3) / 3 ** 0.5])
    aabb = torch.tensor([-cfg.bound] * 3 + [cfg.bound] * 3, device=o.device)
    counts = []
    for s in range(0, o.shape[0], g):
        n, f = near_far_from_aabb(o[s:s + g], d[s:s + g], aabb, cfg.min_near)
        counts.append(marching.march_rays(
            trainer.grid_state.occ, o[s:s + g], d[s:s + g], n, f,
            bound=cfg.bound, max_steps=cfg.max_steps, K=cfg.grid_K,
            dt_gamma=cfg.dt_gamma).counts)
    c = torch.sort(torch.cat(counts)).values.reshape(-1, g).amax(1)
    return int((c > 0).sum()), o.shape[0] // g


def phase_options(guidance=None, steps: int = 10, warmup: int = 2,
                  shampoo_steps: int = 12):
    """The train options at full width (the grid field's 16-level table, SD
    random-full, 64x64): (a) -O --dt_gamma 1/128 --jitter_pose --ema_decay
    0.95 for `steps` steps: kernel F exactly once a step, A, B and K5 as on
    -O, finite losses, the EMA equal to its chain recomputed from the
    parameters after each step (a few leaves, the same f32 arithmetic), then
    an 800x800 orbit frame through the staged eval's march-everything
    fallback: F once per 4,096-ray group (157), B-fwd once per group with an
    emit, the frame against a direct full-K render_grid of the same pose
    (f32 table 1e-4 / 1e-5, the default bf16 view 5e-2 / 2e-2); (b) -O
    --optimizer shampoo for `shampoo_steps` steps (refreshes at counts 1
    and 10): steps/s, the walls of the refresh steps, peak memory, finite
    losses, parameters moved. Returns (counts of (a)'s steps, of its frame,
    of (b), the trainer of (a))."""
    import shutil

    from dreamfusion_torch import cameras
    from dreamfusion_torch.config import parse_config
    from dreamfusion_torch.parallel.jobs import direct_frame
    from dreamfusion_torch.training import trainer as tr_mod
    from dreamfusion_torch.training.optimizers import ema_update

    tmp = tempfile.mkdtemp(prefix="chip_smoke_opt_")
    try:
        argv = _options_argv(os.path.join(tmp, "ws"), steps, "--dt_gamma",
                             "0.0078125", "--jitter_pose", "--ema_decay",
                             "0.95")
        cfg = parse_config(argv)
        trainer = tr_mod.Trainer("options", cfg, guidance=guidance,
                                 use_checkpoint="scratch")
        log(f"[options] python -m dreamfusion_torch.main {' '.join(argv)}")
        leaves = ("sigma_net.dense_0.weight", "sigma_net.dense_2.bias",
                  "bg_net.dense_1.weight", "embeddings")
        chain = {k: trainer.ema[k].clone() for k in leaves}
        params = dict(trainer.model.named_parameters())

        def follow(_):
            ema_update(chain, {k: params[k] for k in leaves}, cfg.ema_decay)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kcuda.reset_counts()
        walls = _stepwise(trainer, steps, follow)
        counts = dict(kcuda.launch_counts)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = torch.stack(trainer.loss_history).float().cpu()
        rate = (steps - warmup) / sum(walls[warmup:])
        ema_gap = max(float((trainer.ema[k] - chain[k]).abs().max())
                      for k in leaves)
        recs = [json.loads(l) for l in open(trainer.log_path)]
        log("[options] loss per step: " + " ".join(f"{float(x):.4g}"
                                                   for x in losses))
        log("[options] (K, M) per step: " + " ".join(
            f"({r['grid_K']},{r['compact_M']})" for r in recs
            if "grid_K" in r) + "; mean count per step: " + " ".join(
            f"{r['mean_count']:.1f}" for r in recs if "mean_count" in r))
        log(f"[options] steps/s after warm-up: {rate:.4f} (steps "
            f"{warmup}..{steps}); step walls "
            + " ".join(f"{w * 1e3:.1f}" for w in walls) + " ms")
        log(f"[options] peak device memory: {peak:.2f} GiB")
        log(f"[options] EMA against its chain recomputed from the parameters "
            f"after each step ({', '.join(leaves)}): max abs diff {ema_gap:g}")
        log(f"[options] kernels {json.dumps(counts)}")
        if not bool(torch.isfinite(losses).all()) or len(losses) != steps:
            raise AssertionError("non-finite loss in the options phase")
        if counts["march_cone"] != steps or min(
                counts[k] for k in TRAIN_KERNELS) <= 0:
            raise AssertionError(f"options: kernel F must launch once a step "
                                 f"and A, B and K5 must launch: {counts}")
        if ema_gap != 0.0:
            raise AssertionError("options: the EMA is not its chain")

        H, W, size = cfg.H, cfg.W, cfg.test_size
        b = cameras.sample_test_batch(1, size, cfg, H=H, W=W,
                                      device=trainer.device)
        o, d = b["rays_o"][0], b["rays_d"][0]
        shaded, groups = _fallback_groups(trainer, o, d)
        trainer._render_orbit_frame(0, size, H, W)      # warm
        kcuda.reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        frame, timings = _recorded(
            lambda: trainer._render_orbit_frame(1, size, H, W))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        ecounts = dict(kcuda.launch_counts)
        log(f"[options] {H}x{W} orbit frame 1 through the fallback: "
            f"{wall:.3f} s ({1 / wall:.4f} frames/s); spans (host ms) "
            + ", ".join(f"{k} {v:.1f}" for k, v in timings.items())
            + f"; {groups} groups, {shaded} with an emit; kernels "
            f"{json.dumps(ecounts)}")
        if (ecounts["march_cone"] != groups
                or ecounts["composite_fwd"] != shaded
                or ecounts["composite_compact"] or not shaded):
            raise AssertionError(f"options frame: F once per group ({groups}) "
                                 f"and B-fwd once per group with an emit "
                                 f"({shaded}): {ecounts}")
        ref = direct_frame(trainer, 1)
        f32 = tr_mod.make_staged_grid_eval(
            cfg.replace(eval_table_bf16=False), trainer.model, H, W)(
                o, d, trainer.grid_state)
        failed = []
        for label, out, rtol, atol in (("f32 table", f32, 1e-4, 1e-5),
                                       ("bf16 table (the default)", frame,
                                        5e-2, 2e-2)):
            err, bad = _frame_gap(out, ref, rtol, atol)
            log(f"[options] fallback vs direct render_grid, {label}: "
                f"max_abs_err {err:.3e}, pixels outside rtol {rtol:g} / atol "
                f"{atol:g}: {bad} of {H * W}")
            failed += [label] if bad else []
        log(f"[options] pixels with weights_sum > 0.5: "
            f"{int((ref['weights_sum'] > 0.5).sum())}")
        _profiled(lambda: trainer._render_orbit_frame(1, size, H, W), 1,
                  "fallback frame", ("eval/",))
        if failed:
            raise AssertionError(f"the fallback frame disagrees with "
                                 f"render_grid: {failed}")

        argv_s = _options_argv(os.path.join(tmp, "ws_s"), shampoo_steps,
                               "--optimizer", "shampoo")
        sh = tr_mod.Trainer("shampoo", parse_config(argv_s),
                            guidance=trainer.guidance,
                            use_checkpoint="scratch")
        before = {k: v.clone() for k, v in sh.model.state_dict().items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kcuda.reset_counts()
        s_walls = _stepwise(sh, shampoo_steps)
        s_counts = dict(kcuda.launch_counts)
        s_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        s_losses = torch.stack(sh.loss_history).float().cpu()
        refresh = [i for i in range(shampoo_steps)
                   if i + 1 <= 1 or (i + 1) % 10 == 0]
        plain = [w for i, w in enumerate(s_walls)
                 if i >= warmup and i not in refresh]
        moved = _params_moved(sh.model, before)
        n_blocks = sum(r[0].shape[0] for st in sh.opt.state.values()
                       for r in st["stats"])
        log(f"[options] python -m dreamfusion_torch.main {' '.join(argv_s)}")
        log(f"[options] shampoo: loss per step " + " ".join(
            f"{float(x):.4g}" for x in s_losses) + "; step walls "
            + " ".join(f"{w * 1e3:.1f}" for w in s_walls) + " ms")
        log(f"[options] shampoo: steps/s over the steps without a refresh "
            f"after warm-up: {len(plain) / sum(plain):.4f}; steps/s over "
            f"steps {warmup}..{shampoo_steps}: "
            f"{(shampoo_steps - warmup) / sum(s_walls[warmup:]):.4f}; "
            f"refresh steps (counts "
            f"{', '.join(str(i + 1) for i in refresh)}): "
            + ", ".join(f"{s_walls[i] * 1e3:.1f} ms" for i in refresh)
            + f"; peak device memory {s_peak:.2f} GiB; statistic groups "
            f"{n_blocks}; parameters moved by at most {moved:.3e}")
        log(f"[options] shampoo kernels {json.dumps(s_counts)}")
        if (not bool(torch.isfinite(s_losses).all())
                or len(s_losses) != shampoo_steps or not moved > 0):
            raise AssertionError("shampoo: non-finite loss or no movement")
        if min(s_counts[k] for k in TRAIN_KERNELS) <= 0:
            raise AssertionError(f"shampoo: a kernel of -O never launched: "
                                 f"{s_counts}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts, ecounts, s_counts, trainer


def phase_dp(steps: int = 3):
    """Two data-parallel ranks on the one card, gloo (NCCL takes one rank a
    card), through sharding.spawn and jobs.train_job: full-width -O with SD
    random-full for `steps` steps. The first step's averaged gradients must
    equal the mean of the ranks' own (1e-6 of each leaf's largest entry),
    the parameters and the occupancy grid must be the same bits on both
    ranks after every step, and the ray-sharded 800x800 orbit frame must
    equal rank 0's direct render_grid of the same pose (1e-6). Returns rank
    0's launch counts."""
    import shutil

    from dreamfusion_torch.parallel import jobs, sharding

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        argv = _options_argv(os.path.join(tmp, "ws"), steps)
        devices = [torch.device("cuda", 0)] * 2
        log(f"[dp] 2 ranks, backend gloo, devices {devices}: "
            f"python -m dreamfusion_torch.main {' '.join(argv)}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sharding.spawn(jobs.train_job, (argv, steps, 1), devices,
                             "gloo", timeout_s=300.0, join_timeout_s=900.0)
        log(f"[dp] ranks done in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0, r1 = res
    grad_gap = max(rel_err(r0["averaged"][k],
                           (r0["local"][k] + r1["local"][k]) / 2)
                   for k in r0["averaged"])
    apart = max(rel_err(r0["local"][k], r1["local"][k]) for k in r0["local"])
    same = [a == b for a, b in zip(r0["digests"], r1["digests"])]
    frame_gap = max(float((r0["frame"][k] - r0["direct"][k]).abs().max())
                    for k in ("image", "depth", "weights_sum"))
    walls = [max(a, b) for a, b in zip(r0["walls"], r1["walls"])]
    log(f"[dp] losses rank 0 {r0['losses']}, rank 1 {r1['losses']}; budgets "
        f"{r0['budgets']} / {r1['budgets']}")
    log(f"[dp] first step: averaged gradients vs the mean of the ranks' own "
        f"{grad_gap:.2e} of the largest entry (the ranks' own differ by "
        f"{apart:.2e}); parameters and grid the same bits after each step: "
        f"{same}")
    log(f"[dp] step walls (slower rank) " + " ".join(
        f"{w * 1e3:.1f}" for w in walls) + f" ms; steps/s over steps 1.."
        f"{steps}: {(steps - 1) / sum(walls[1:]):.4f}; all-reduce of the "
        f"gradients {r0['allreduce_s'] / r0['allreduces'] * 1e3:.2f} ms a "
        f"step (rank 0, {r0['allreduces']} all-reduces, gloo through host "
        f"memory), after a wait for the other rank of "
        f"{r0['wait_s'] / r0['allreduces'] * 1e3:.2f} ms a step")
    H, W = r0["frame"]["weights_sum"].shape
    log(f"[dp] ray-sharded {H}x{W} frame: {r0['frame_s']:.3f} s (rank 0), "
        f"max abs diff to rank 0's direct render_grid {frame_gap:.3e}")
    log(f"[dp] kernels (rank 0) {json.dumps(r0['launches'])}")
    if not all(same) or grad_gap > 1e-6 or frame_gap > 1e-6:
        raise AssertionError("dp: the ranks disagree or the averaged "
                             "gradients or the sharded frame are off")
    if not apart > 0 or min(r0["launches"][k] for k in TRAIN_KERNELS) <= 0:
        raise AssertionError(f"dp: the ranks drew alike or a kernel of -O "
                             f"never launched: {r0['launches']}")
    return r0["launches"]


def _frame_gap(out, ref, rtol, atol):
    """(max abs error over image, weights_sum and depth; pixels where any
    of them lies outside atol + rtol |ref|)."""
    err, off = 0.0, None
    for k in ("image", "weights_sum", "depth"):
        b = ref[k].reshape(ref[k].shape[0], -1)
        gap = (out[k].reshape(b.shape) - b).abs()
        err = max(err, float(gap.max()))
        o = (gap > atol + rtol * b.abs()).any(-1)
        off = o if off is None else off | o
    return err, int(off.sum())


def phase_eval(trainer, frames: int = 3):
    """The staged 800x800 eval on the trained trainer: frames/s and stage
    walls over the same frames, the eval path's launch counts, and a staged
    frame against the direct full-K render_grid. Returns (counts, captured
    inputs of kernels C and D).

    Each timed frame ends its stages in a device sync. Classify and march
    end in a host transfer anyway, so the syncs add little; frames/s is
    read from the synced frames so that the stage walls sum to it."""
    from dreamfusion_torch.ops import marching, probe

    cfg = trainer.cfg
    H, W, size = cfg.H, cfg.W, cfg.test_size
    gs = trainer.grid_state
    log(f"[eval] {H}x{W} frames of a {size}-frame orbit; group "
        f"{cfg.max_ray_batch}, grid {cfg.grid_size}^3 ({float(gs.occ.float().mean()):.4f} "
        f"occupied), max_steps {cfg.max_steps}, grid_K {cfg.grid_K}, bf16 "
        f"table {cfg.eval_table_bf16}")
    torch.cuda.synchronize()
    kcuda.reset_counts()
    t0 = time.perf_counter()
    trainer._render_orbit_frame(0, size, H, W)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    walls, stages, outs, shaded = [], [], [], []
    for i in range(1, frames + 1):
        before = dict(kcuda.launch_counts)
        t1 = time.perf_counter()
        out, timings = _recorded(
            lambda: trainer._render_orbit_frame(i, size, H, W))
        outs.append(out)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        stages.append({k: v * 1e-3 for k, v in timings.items()
                       if k.startswith("eval/")})
        # each shaded group launches kernel C (compact) or B-fwd (dense)
        shaded.append(tuple(kcuda.launch_counts[k] - before[k]
                            for k in ("composite_compact", "composite_fwd")))
    counts = dict(kcuda.launch_counts)
    dt = sum(walls)
    ms = lambda xs: ", ".join(f"{x * 1e3:.2f}" for x in xs)  # noqa: E731
    log(f"[eval] warm frame {warm:.3f} s; frames/s over frames 1..{frames}: "
        f"{frames / dt:.4f} ({dt / frames * 1e3:.2f} ms a frame; frames "
        f"{ms(walls)} ms)")
    for name in stages[0]:
        vals = [s.get(name, 0.0) for s in stages]
        log(f"[eval] stage {name}, host time over frames 1..{frames}: "
            f"mean {sum(vals) / frames * 1e3:.2f} ms (frames {ms(vals)})")
    log(f"[eval] stages' host time summed per frame "
        f"{ms(sum(s.values()) for s in stages)} ms; the rest of each "
        f"frame's wall (its rays, the host between stages, the device "
        f"after the last launch) "
        f"{ms(w - sum(s.values()) for w, s in zip(walls, stages))} ms")
    log("[eval] groups shaded per frame, compact (C) + dense (B-fwd): "
        + ", ".join(f"{c} + {b}" for c, b in shaded))
    log(f"[eval] kernels {json.dumps(counts)}")
    if min(counts[k] for k in EVAL_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the eval path never launched: "
                             f"{counts}")
    for out in outs:
        if out["image"].shape != (H, W, 3) or not all(
                bool(torch.isfinite(v).all()) for v in out.values()):
            raise AssertionError("eval frame of the wrong shape or not finite")

    # frame 1 again (untimed), keeping the inputs of kernels C and D and
    # counting the field queries (one kernel H launch each)
    captured = {"C": {}, "D": None}
    probe_fn = probe.probe_select_small
    queries = []

    def probe_spy(table, idx):
        captured["D"] = (table.clone(), idx.clone())
        return probe_fn(table, idx)

    def encode_spy(x, *args, **kw):
        queries.append(x.shape[0])
        return type(trainer.model).encode(trainer.model, x, *args, **kw)

    probe.probe_select_small = probe_spy
    trainer.model.encode = encode_spy
    h0 = kcuda.launch_counts["grid_encoder_fwd"]
    try:
        with compact_groups(captured["C"]) as groups:
            staged = trainer._render_orbit_frame(1, size, H, W)
    finally:
        probe.probe_select_small = probe_fn
        del trainer.model.encode
    h = kcuda.launch_counts["grid_encoder_fwd"] - h0
    log(f"[eval] frame 1: {len(queries)} field queries of "
        f"{sum(queries):,} samples, {h} grid_encoder_fwd launches")
    if h != len(queries) or not queries:
        raise AssertionError("kernel H must launch once per field query")
    log("[eval] compact budgets (samples in a group: groups) "
        + ", ".join(f"{J:,}: {n}" for J, (n, _) in sorted(captured["C"].items()))
        + f"; classify probes {captured['D'][1].shape[0]:,} into a table of "
        f"{captured['D'][0].shape[0]:,}")
    log(f"[eval] frame 1: {groups['calls']} compact groups, "
        f"{groups['launches']} composite_compact launches")

    _staged_vs_direct("eval", trainer, 1, [("bf16 table (the default)",
                                            staged, 5e-2, 2e-2)])
    _profiled(lambda: trainer._render_orbit_frame(1, size, H, W), 1,
              "eval frame", ("eval/",))
    return counts, captured


@contextlib.contextmanager
def compact_groups(keep=None):
    """Counts the calls of marching.composite_compact (one per compact
    group the staged eval shades) and kernel C's launches over the block,
    which must be equal; keep (a dict) receives, for each budget M, a copy
    of the inputs of its group with the most samples, as {M: (calls,
    (samples, cmap, N, T_thresh))}."""
    from dreamfusion_torch.ops import marching

    fn = marching.composite_compact
    out = {"calls": 0, "launches": 0}

    def spy(sigma_c, color_c, t_c, dt_c, cmap, N, T_thresh=0.0):
        out["calls"] += 1
        if keep is not None:
            M = sigma_c.shape[0]
            n, old = keep.get(M, (0, None))
            if old is None or int(cmap.cnt.sum()) > int(old[1].cnt.sum()):
                old = (tuple(x.clone() for x in (sigma_c, color_c, t_c,
                                                 dt_c)),
                       marching.CompactMap(*(x.clone() for x in cmap)), N,
                       T_thresh)
            keep[M] = (n + 1, old)
        return fn(sigma_c, color_c, t_c, dt_c, cmap, N, T_thresh)

    n0 = kcuda.launch_counts["composite_compact"]
    marching.composite_compact = spy
    try:
        yield out
    finally:
        marching.composite_compact = fn
    out["launches"] = kcuda.launch_counts["composite_compact"] - n0
    if out["launches"] != out["calls"] or not out["calls"]:
        raise AssertionError(f"kernel C must launch once per compact group: "
                             f"{out}")


def _staged_vs_direct(tag, trainer, frame: int, extra_checks=(),
                      cut_tol=(1e-4, 1e-5)):
    """Orbit frame `frame` through the staged eval at the f32 setting, with
    the live cut and without, against the direct full-K render_grid of the
    same pose in 4,096-ray chunks (rtol 1e-4 / atol 1e-5; the default-cut
    row at cut_tol, and where that is looser its pixels outside 1e-4 / 1e-5
    are printed too); extra_checks adds (label, staged frame, rtol, atol)
    rows against the same reference."""
    from dreamfusion_torch import cameras
    from dreamfusion_torch.models.networks import make_field_fns
    from dreamfusion_torch.ops import marching
    from dreamfusion_torch.training import trainer as tr_mod

    cfg, gs = trainer.cfg, trainer.grid_state
    H, W = cfg.H, cfg.W
    b = cameras.sample_test_batch(frame, cfg.test_size, cfg, H=H, W=W,
                                  device=trainer.device)
    o, d = b["rays_o"][0], b["rays_d"][0]
    fns = make_field_fns(trainer.model)._replace(normal=None)
    t0 = time.perf_counter()
    with torch.no_grad():
        parts = [marching.render_grid(
            fns, gs, o[s:s + 4096], d[s:s + 4096], bound=cfg.bound,
            min_near=cfg.min_near, max_steps=cfg.max_steps, K=cfg.grid_K,
            bg_radius=cfg.bg_radius, light_d=cameras.safe_normalize(o[0]),
            perturb=False) for s in range(0, o.shape[0], 4096)]
    ref = {k: torch.cat([p[k] for p in parts])
           for k in ("image", "weights_sum", "depth")}
    torch.cuda.synchronize()
    log(f"[{tag}] direct render_grid of frame {frame}: "
        f"{time.perf_counter() - t0:.2f} s; pixels with weights_sum > 0.5: "
        f"{int((ref['weights_sum'] > 0.5).sum())} of {H * W}")
    f32 = tr_mod.make_staged_grid_eval(cfg.replace(eval_table_bf16=False),
                                       trainer.model, H, W)
    logt = tr_mod._LIVE_LOGT
    tr_mod._LIVE_LOGT = math.inf
    try:
        f32_nocut = f32(o, d, gs)
    finally:
        tr_mod._LIVE_LOGT = logt
    checks = [("f32, live cut off", f32_nocut, 1e-4, 1e-5),
              ("f32, default live cut", f32(o, d, gs), *cut_tol),
              *extra_checks]
    failed = []
    for label, out, rtol, atol in checks:
        err, bad = _frame_gap(out, ref, rtol, atol)
        log(f"[{tag}] staged vs direct, {label}: max_abs_err {err:.3e}, "
            f"pixels outside rtol {rtol:g} / atol {atol:g}: {bad} of {H * W}"
            + ("" if (rtol, atol) <= (1e-4, 1e-5) else
               f" (outside 1e-4 / 1e-5: {_frame_gap(out, ref, 1e-4, 1e-5)[1]})"))
        if bad:
            failed.append(label)
    if failed:
        raise AssertionError(f"staged eval disagrees with render_grid: {failed}")
    return ref


def _hashgrid_inputs(dev):
    """The hashgrid phase's encoder and points: the default hash spec and
    HASHGRID_POINTS points uniform in [-1.05, 1.05]^3 (about 14% of them
    outside the encoder's box), from a fixed seed."""
    from dreamfusion_torch.ops.encoders import get_encoder

    spec, out_dim = get_encoder("hashgrid")
    gen = torch.Generator(device=dev).manual_seed(3)
    x = (torch.rand(HASHGRID_POINTS, 3, device=dev, generator=gen) * 2 - 1) * 1.05
    return spec, out_dim, x, gen


def phase_hashgrid(steps: int = 3):
    """The hash grid encoder at its default spec: `steps` Adam steps of the
    table toward a fixed target. Returns the launch counts."""

    dev = torch.device("cuda")
    spec, out_dim, x, gen = _hashgrid_inputs(dev)
    table = torch.nn.Parameter(spec.init(gen, dev))
    target = 1e-2 * torch.randn(x.shape[0], out_dim, device=dev, generator=gen)
    oob = (x.abs() > 1.0).any(-1)
    opt = torch.optim.Adam([table], lr=1e-3, betas=(0.9, 0.99), eps=1e-15)
    log(f"[hashgrid] get_encoder('hashgrid'): L={spec.num_levels} "
        f"C={spec.level_dim} T={spec.table_size:,} rows, hashed levels "
        f"{[l for l, h in enumerate(spec.hashed_levels) if h]}; B="
        f"{x.shape[0]:,} points, {int(oob.sum()):,} outside the box")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kcuda.reset_counts()
    losses, t0 = [], time.perf_counter()
    for _ in range(steps):
        out = spec(table, x)
        loss = ((out - target) ** 2).sum()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(kcuda.launch_counts)
    losses = [float(l) for l in losses]
    final = float(((spec(table.detach(), x) - target) ** 2).sum())
    log(f"[hashgrid] loss per step {' '.join(f'{l:.6g}' for l in losses)} "
        f"-> {final:.6g}; {dt / steps * 1e3:.1f} ms a step (forward, "
        f"backward, Adam)")
    log(f"[hashgrid] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    log(f"[hashgrid] kernels {json.dumps(counts)}")
    if not (all(math.isfinite(l) for l in losses + [final])
            and all(b < a for a, b in zip(losses, losses[1:] + [final]))):
        raise AssertionError("hashgrid loss not finite or not falling")
    if out.shape != (x.shape[0], out_dim) or bool(out[oob].abs().any()) \
            or not bool(out[~oob].abs().any()):
        raise AssertionError("hashgrid output: wrong shape, or points "
                             "outside the box do not read zeros")
    if counts["grid_encoder_bwd_rows"] != steps or counts["grid_encoder_bwd"]:
        raise AssertionError(f"hashgrid: kernel E must launch once per "
                             f"backward and kernel A never: {counts}")
    return counts


def write_dvgo(path: str, seed: int = 0, world: int = 160, k0_dim: int = 12,
               width: int = 128, radius: float = 0.4, slope: float = 100.0,
               noise: float = 0.5) -> dict:
    """A .dvgo checkpoint (a torch-lightning file: state_dict and
    hyper_parameters) at the width of a DVGO fine model, from a seed:
    density a noisy ball in the +-1 box, clamp((radius - r) * slope, -10,
    30) plus noise of std `noise` (the defaults: a ramp from +30 at radius
    0.1 to -10 at 0.5; with DVGO's act_shift of -13.8 the surface lies near
    radius 0.26); a `width` x 3 residual colour MLP on k0_dim feature
    channels with PE 5 (position) and 4 (view)."""
    g = torch.Generator().manual_seed(seed)
    lin = torch.linspace(-1.0, 1.0, world)
    X, Y, Z = torch.meshgrid(lin, lin, lin, indexing="ij")
    r = torch.sqrt(X * X + Y * Y + Z * Z)
    density = torch.clamp((radius - r) * slope, -10.0, 30.0) \
        + noise * torch.randn(world, world, world, generator=g)
    in_dim = k0_dim + (3 + 3 * 5 * 2) + (3 + 3 * 4 * 2)
    lin_w = lambda o, i: torch.randn(o, i, generator=g) / math.sqrt(i)  # noqa: E731
    state = {
        "density": density[None, None].contiguous(),
        "k0": torch.randn(1, k0_dim, world, world, world, generator=g),
        "xyz_min": torch.tensor([-1.0, -1.0, -1.0]),
        "xyz_max": torch.tensor([1.0, 1.0, 1.0]),
        "voxel_size_ratio": torch.tensor(1.0),
        "rgbnet.net.0.weight": lin_w(width, in_dim),
        "rgbnet.net.0.bias": torch.zeros(width),
        "rgbnet.net.2.net.weight": lin_w(width, width),
        "rgbnet.net.2.net.bias": torch.zeros(width),
        "rgbnet.net.3.weight": lin_w(3, width),
        "rgbnet.net.3.bias": torch.zeros(3),
    }
    torch.save({"state_dict": state, "hyper_parameters": {"params": {"cfg": {
        "fine_model_and_render": {
            "rgbnet": "resmlp", "rgbnet_width": width, "rgbnet_depth": 3,
            "posbase_pe": 5, "viewbase_pe": 4, "alpha_init": 1e-6,
            "stepsize": 0.5}}}}}, path)
    return state


def phase_edit(guidance=None, steps: int = 10, warmup: int = 2):
    """Single-scene editing through the Trainer (`--backbone dvgo`), then
    one staged 800x800 eval frame of the edited field against the direct
    render. Returns (train launch counts, eval-frame launch counts, the
    trainer; its workspace is removed, its model and guidance stay)."""
    import shutil

    from dreamfusion_torch.config import parse_config
    from dreamfusion_torch.training.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_edit_")
    try:
        scene = os.path.join(tmp, "scene.dvgo")
        t0 = time.perf_counter()
        state = write_dvgo(scene)
        t_write = time.perf_counter() - t0
        argv = ["-O", "--backbone", "dvgo", "--pretrained_dvgo", scene,
                "--bg_radius", "0", "--text", "a golden ficus",
                "--sd_weights", "random-full", "--iters", str(steps),
                "--albedo_iters", str(steps // 2), "--workspace",
                os.path.join(tmp, "ws"), "--ckpt", "scratch", "--seed", "0"]
        cfg = parse_config(argv)
        t0 = time.perf_counter()
        trainer = Trainer("edit", cfg, guidance=guidance,
                          use_checkpoint="scratch")
        torch.cuda.synchronize()
        model = trainer.model
        log(f"[edit] python -m dreamfusion_torch.main {' '.join(argv)}")
        log(f"[edit] scene written in {t_write:.1f} s "
            f"({os.path.getsize(scene) / 2 ** 20:.0f} MiB), trainer set up in "
            f"{time.perf_counter() - t0:.1f} s (SD guidance "
            f"{'shared with the train phase' if guidance is not None else 'built here'}); "
            f"density {tuple(model.main.density.shape)}, k0 "
            f"{tuple(model.main.k0.shape)}, rgbnet "
            f"{sum(p.numel() for p in model.main.rgbnet.parameters()):,} "
            f"parameters")
        rgb0 = {k: v.clone() for k, v in model.main.rgbnet.state_dict().items()}

        rate, counts, losses, recs, peak = _train_timed(trainer, steps,
                                                        warmup)
        log("[edit] loss per step: " + " ".join(f"{float(x):.4g}" for x in losses))
        log("[edit] shading code per step: " + " ".join(
            str(int(r["shading_code"])) for r in recs)
            + f"; occupied cells {float(trainer.grid_state.occ.float().mean()):.4f}")
        log(f"[edit] steps/s after warm-up: {rate:.4f} "
            f"(steps {warmup}..{steps}, dense K={trainer._cur_grid_K})")
        log(f"[edit] peak device memory: {peak:.2f} GiB")
        log(f"[edit] kernels {json.dumps(counts)}")
        if not bool(torch.isfinite(losses).all()) or len(losses) != steps:
            raise AssertionError("non-finite loss in the edit phase")
        for name, ref in (("density", state["density"][0]),
                          ("k0", state["k0"][0])):
            p = getattr(model.main, name)
            if p.requires_grad or not torch.equal(p.detach().cpu(), ref):
                raise AssertionError(f"the frozen {name} grid changed")
        moved = max(float((v - rgb0[k]).abs().max())
                    for k, v in model.main.rgbnet.state_dict().items())
        log(f"[edit] frozen grids bitwise unchanged; rgbnet moved by at most "
            f"{moved:.3e}")
        if not moved > 0:
            raise AssertionError("the colour MLP did not move")
        if min(counts[k] for k in EDIT_TRAIN_KERNELS) <= 0 \
                or any(counts[k] for k in ENCODER_KERNELS):
            raise AssertionError(f"edit: kernels B and the flash kernels must "
                                 f"launch, the encoder kernels not: {counts}")

        H, W, size = cfg.H, cfg.W, cfg.test_size
        kcuda.reset_counts()
        trainer._render_orbit_frame(0, size, H, W)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with compact_groups() as groups:
            out, timings = _recorded(
                lambda: trainer._render_orbit_frame(1, size, H, W))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t2
        ecounts = dict(kcuda.launch_counts)
        log(f"[edit] {H}x{W} staged eval frame 1: {wall * 1e3:.2f} ms (spans,"
            " host ms: "
            + ", ".join(f"{k} {v:.2f}" for k, v in timings.items())
            + f"); {groups['calls']} compact groups, "
            f"{groups['launches']} composite_compact launches")
        _profiled(lambda: trainer._render_orbit_frame(1, size, H, W), 1,
                  "edit frame", ("eval/",))
        log(f"[edit] eval-frame kernels (2 frames) {json.dumps(ecounts)}")
        if out["image"].shape != (H, W, 3) or not all(
                bool(torch.isfinite(v).all()) for v in out.values()):
            raise AssertionError("edit eval frame of the wrong shape or not "
                                 "finite")
        if min(ecounts[k] for k in EDIT_EVAL_KERNELS) <= 0:
            raise AssertionError(f"a kernel of the edit eval frame never "
                                 f"launched: {ecounts}")
        ref = _staged_vs_direct("edit", trainer, 1)
        if not int((ref["weights_sum"] > 0.5).sum()) > 1000:
            raise AssertionError("the edit frame shows no object")

        # a steeper scene (the ramp half as wide, twice the noise), as a
        # fine model's surfaces are: where the live estimate's cell maximum
        # overstates the density by more than its margin of 1.2, the
        # default cut drops a tail that still carries about T_thresh = 1e-4
        # of weight. That row is held to atol 2e-4, the cut-off row to the
        # same 1e-4 / 1e-5 as above
        steep_scene = os.path.join(tmp, "steep.dvgo")
        write_dvgo(steep_scene, radius=0.45, slope=200.0, noise=1.0)
        steep = Trainer("edit_steep", cfg.replace(
            pretrained_dvgo=steep_scene, workspace=os.path.join(tmp, "ws2")),
            guidance=trainer.guidance, use_checkpoint="scratch")
        steep.update_grid(0)
        log(f"[edit-steep] ball edge 0.2 wide, noise 1; occupied cells "
            f"{float(steep.grid_state.occ.float().mean()):.4f}")
        ref = _staged_vs_direct("edit-steep", steep, 1, cut_tol=(1e-4, 2e-4))
        if not int((ref["weights_sum"] > 0.5).sum()) > 1000:
            raise AssertionError("the steep edit frame shows no object")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts, ecounts, trainer


def _train_timed(trainer, steps: int, warmup: int):
    """Train to `warmup` steps, then on to `steps` with the launch counts
    set to 0 just before and read just after the whole run, peak memory
    from its start. Returns (steps/s after the warm-up, counts, losses,
    log records, peak GiB)."""

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kcuda.reset_counts()
    trainer.train(max_steps=warmup, log_interval=1, checkpoint_at_end=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    trainer.train(max_steps=steps, log_interval=1, checkpoint_at_end=True)
    torch.cuda.synchronize()
    rate = (steps - warmup) / (time.perf_counter() - t1)
    counts = dict(kcuda.launch_counts)
    losses = torch.stack(trainer.loss_history).float().cpu()
    recs = [json.loads(l) for l in open(trainer.log_path)]
    return (rate, counts, losses, recs,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def _params_moved(model, before) -> float:
    return max(float((v - before[k]).abs().max())
               for k, v in model.state_dict().items())


def _o2_chunk_vs_cpu(trainer, frame_out, chunk: int = 4096):
    """One chunk of rays of the orbit frame (the one holding the frame's
    centre) rendered again by the stratified renderer on the CPU from a copy
    of the trainer's model: (1) the frame's own pixels against the copy as
    trained (bf16 MLPs, the eval's regime), held to the bf16 view's 5e-2 /
    2e-2 and its pixels outside 1e-4 / 1e-5 printed; (2) the same chunk with
    both copies computing in f32 on the GPU and on the CPU, held to 1e-4 /
    1e-5."""
    from dreamfusion_torch import cameras
    from dreamfusion_torch.models.networks import make_field_fns
    from dreamfusion_torch.renderer import render_stratified

    cfg = trainer.cfg
    H, W = cfg.H, cfg.W
    b = cameras.sample_test_batch(1, cfg.test_size, cfg, H=H, W=W,
                                  device=trainer.device)
    o, d = b["rays_o"][0], b["rays_d"][0]
    light_d = cameras.safe_normalize(o[0])
    s0 = (H * W // 2) // chunk * chunk
    sl = slice(s0, s0 + chunk)

    def render(model, dev):
        with torch.no_grad():
            out = render_stratified(
                make_field_fns(model)._replace(normal=None), o[sl].to(dev),
                d[sl].to(dev), bound=cfg.bound, min_near=cfg.min_near,
                num_steps=cfg.num_steps, upsample_steps=cfg.upsample_steps,
                bg_radius=cfg.bg_radius, light_d=light_d.to(dev))
        return {k: out[k].cpu() for k in ("image", "weights_sum", "depth")}

    def f32(model):
        for m in model.modules():
            if hasattr(m, "dtype") and isinstance(m.dtype, torch.dtype):
                m.dtype = torch.float32
        return model

    m_cpu = copy.deepcopy(trainer.model).cpu()
    t0 = time.perf_counter()
    ref = render(m_cpu, torch.device("cpu"))
    t_cpu = time.perf_counter() - t0
    frame = {k: frame_out[k].reshape(H * W, -1)[sl].squeeze(-1).float().cpu()
             for k in ("image", "weights_sum", "depth")}
    err, bad = _frame_gap(frame, ref, 5e-2, 2e-2)
    _, bad_tight = _frame_gap(frame, ref, 1e-4, 1e-5)
    log(f"[o2] frame 1 rays {s0:,}..{s0 + chunk:,} against the CPU plain "
        f"path ({t_cpu:.1f} s on the CPU), as trained (bf16 MLPs): "
        f"max_abs_err {err:.3e}, pixels outside rtol 5e-2 / atol 2e-2: {bad} "
        f"of {chunk} (outside 1e-4 / 1e-5: {bad_tight})")
    g32 = render(f32(copy.deepcopy(trainer.model)), trainer.device)
    c32 = render(f32(m_cpu), torch.device("cpu"))
    err32, bad32 = _frame_gap(g32, c32, 1e-4, 1e-5)
    log(f"[o2] the same rays with both copies in f32, GPU against CPU: "
        f"max_abs_err {err32:.3e}, pixels outside rtol 1e-4 / atol 1e-5: "
        f"{bad32} of {chunk}")
    if bad or bad32:
        raise AssertionError("the -O2 eval chunk disagrees with the CPU "
                             "plain path")


def phase_o2(guidance=None, steps: int = 10, warmup: int = 2,
             c1_steps: int = 5, c1_warmup: int = 1):
    """-O2 (path A) through the Trainer. (a) the grid backbone with SD
    random-full (the train phase's guidance object when that phase ran),
    `steps` steps, half of them past --albedo_iters so shaded steps run the
    finite-difference normals; kernel A must launch once per field query
    in a backward (1 on an albedo step, 7 on a shaded one) and the flash
    kernels must launch. (b) one 800x800 orbit frame through
    Trainer._render_orbit_frame (157 chunks of 4,096 rays) and a chunk of
    it against the CPU plain path. (c) BASELINE config 1 at full width:
    the vanilla backbone with CLIP random-tiny, c1_steps steps with
    autograd normals after --albedo_iters 2; it launches no hand-written
    kernel. Returns (launch counts of (a), of (b), of (c), the trainer of
    (a))."""
    import shutil

    from dreamfusion_torch.config import parse_config
    from dreamfusion_torch.training.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_o2_")
    try:
        argv = ["-O2", "--text", "a hamburger", "--sd_weights", "random-full",
                "--iters", str(steps), "--albedo_iters", str(steps // 2),
                "--workspace", os.path.join(tmp, "ws"), "--ckpt", "scratch",
                "--seed", "0"]
        cfg = parse_config(argv)
        t0 = time.perf_counter()
        trainer = Trainer("o2", cfg, guidance=guidance,
                          use_checkpoint="scratch")
        torch.cuda.synchronize()
        log(f"[o2] python -m dreamfusion_torch.main {' '.join(argv)}")
        log(f"[o2] set up in {time.perf_counter() - t0:.1f} s (SD guidance "
            f"{'shared with the train phase' if guidance is not None else 'built here'}); "
            f"renderer {trainer.renderer}, {cfg.h}x{cfg.w} rays x "
            f"{cfg.num_steps} + {cfg.upsample_steps} samples; grid table "
            f"{trainer.model.embeddings.shape[0]:,} rows")
        before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        rate, counts, losses, recs, peak = _train_timed(trainer, steps, warmup)
        codes = [int(r["shading_code"]) for r in recs]
        want_a = sum(1 if c == 0 else 7 for c in codes)
        moved = _params_moved(trainer.model, before)
        log("[o2] loss per step: " + " ".join(f"{float(x):.4g}" for x in losses))
        log(f"[o2] shading code per step: {' '.join(map(str, codes))}; "
            f"kernel A launches {counts['grid_encoder_bwd']} (1 per albedo "
            f"step, 7 per shaded step: {want_a})")
        log(f"[o2] steps/s after warm-up: {rate:.4f} (steps {warmup}..{steps})")
        log(f"[o2] peak device memory: {peak:.2f} GiB")
        log(f"[o2] parameters moved by at most {moved:.3e}")
        log(f"[o2] kernels {json.dumps(counts)}")
        if not bool(torch.isfinite(losses).all()) or len(losses) != steps:
            raise AssertionError("non-finite loss in the -O2 phase")
        if counts["grid_encoder_bwd"] != want_a or min(
                counts[k] for k in O2_TRAIN_KERNELS) <= 0:
            raise AssertionError(f"-O2: kernel A must launch once per field "
                                 f"query in a backward and the flash kernels "
                                 f"must launch: {counts}")
        if not moved > 0:
            raise AssertionError("-O2: the parameters did not move")

        H, W, size = cfg.H, cfg.W, cfg.test_size
        kcuda.reset_counts()
        t1 = time.perf_counter()
        out, timings = _recorded(
            lambda: trainer._render_orbit_frame(1, size, H, W))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        ecounts = dict(kcuda.launch_counts)
        log(f"[o2] {H}x{W} orbit frame 1 ({-(-H * W // cfg.max_ray_batch)} "
            f"chunks of {cfg.max_ray_batch} rays): {wall:.3f} s, "
            f"{1 / wall:.4f} frames/s; spans (host ms) "
            + ", ".join(f"{k} {v:.1f}" for k, v in timings.items())
            + "; pixels with weights_sum > 0.5: "
            f"{int((out['weights_sum'] > 0.5).sum())}; kernels "
            f"{json.dumps(ecounts)}")
        if out["image"].shape != (H, W, 3) or not all(
                bool(torch.isfinite(v).all()) for v in out.values()):
            raise AssertionError("-O2 frame of the wrong shape or not finite")
        _o2_chunk_vs_cpu(trainer, out)

        argv1 = ["-O2", "--backbone", "vanilla", "--guidance", "clip",
                 "--clip_weights", "random-tiny", "--text", "a hamburger",
                 "--iters", str(c1_steps), "--albedo_iters", "2",
                 "--workspace", os.path.join(tmp, "ws1"), "--ckpt",
                 "scratch", "--seed", "0"]
        c1 = Trainer("config1", parse_config(argv1), use_checkpoint="scratch")
        before = {k: v.clone() for k, v in c1.model.state_dict().items()}
        rate1, counts1, losses1, recs1, peak1 = _train_timed(c1, c1_steps,
                                                             c1_warmup)
        moved1 = _params_moved(c1.model, before)
        log(f"[config1] python -m dreamfusion_torch.main {' '.join(argv1)}")
        log(f"[config1] lambda_entropy {c1.cfg.lambda_entropy}, "
            f"lambda_opacity {c1.cfg.lambda_opacity} (finalize); loss per "
            f"step: " + " ".join(f"{float(x):.4g}" for x in losses1)
            + "; shading code per step: "
            + " ".join(str(int(r["shading_code"])) for r in recs1))
        log(f"[config1] steps/s after warm-up: {rate1:.4f} (steps "
            f"{c1_warmup}..{c1_steps}); peak device memory {peak1:.2f} GiB; "
            f"parameters moved by at most {moved1:.3e}")
        log(f"[config1] no hand-written kernel on this path (the vanilla "
            f"field has no table, CLIP's attention is plain): "
            f"{json.dumps(counts1)}")
        if not bool(torch.isfinite(losses1).all()) or len(losses1) != c1_steps:
            raise AssertionError("non-finite loss in config 1")
        if not moved1 > 0 or any(counts1.values()):
            raise AssertionError(f"config 1: parameters must move and no "
                                 f"kernel launch: {counts1}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts, ecounts, counts1, trainer


def _o2_positions(trainer):
    """The field-query positions of one -O2 step of the trainer: a fresh
    camera batch through the stratified sampler (coarse pass, importance
    samples, merged), 4,096 rays x 128 samples, every one inside the box
    (the renderer clips them)."""
    from dreamfusion_torch import cameras
    from dreamfusion_torch.models.networks import make_field_fns
    from dreamfusion_torch.renderer import render_stratified

    cfg = trainer.cfg
    b = cameras.sample_train_batch(cfg, generator=trainer.gen,
                                   device=trainer.device)
    fns = make_field_fns(trainer.model)._replace(normal=None)
    got = {}

    def field(x, *args):
        got["x"] = x.detach().clone()
        return fns.field(x, *args)

    with torch.no_grad():
        render_stratified(fns._replace(field=field),
                          b["rays_o"].reshape(-1, 3), b["rays_d"].reshape(-1, 3),
                          bound=cfg.bound, min_near=cfg.min_near,
                          num_steps=cfg.num_steps,
                          upsample_steps=cfg.upsample_steps,
                          bg_radius=cfg.bg_radius, perturb=True,
                          generator=trainer.gen)
    return got["x"]


def _real_positions(trainer, dense: bool = False):
    """Field-query positions of one main-path step: a fresh camera batch,
    marched on the trained occupancy grid at the current (K, M) budgets, or
    at K with no compaction (dense: the N x K query of steps 0-15)."""
    from dreamfusion_torch import cameras
    from dreamfusion_torch.ops import marching
    from dreamfusion_torch.ops.composite import near_far_from_aabb

    cfg = trainer.cfg
    b = cameras.sample_train_batch(cfg, generator=trainer.gen,
                                   device=trainer.device)
    o, d = b["rays_o"].reshape(-1, 3), b["rays_d"].reshape(-1, 3)
    aabb = torch.tensor([-1.0] * 3 + [1.0] * 3, device=o.device)
    near, far = near_far_from_aabb(o, d, aabb, cfg.min_near)
    K, M = trainer._cur_grid_K, None if dense else trainer._cur_compact_M
    m = marching.march_rays(trainer.grid_state.occ, o, d, near, far,
                            bound=1.0, max_steps=cfg.max_steps, K=K,
                            perturb=True, generator=trainer.gen)
    if M is not None and M < o.shape[0] * K:
        cm = marching.make_compact_map(m.counts, K, M)
        t = m.ts.reshape(-1)[cm.fwd_flat]
        x = o[cm.ray_of_m] + d[cm.ray_of_m] * t[:, None]
        valid = cm.valid_m & m.valid.reshape(-1)[cm.fwd_flat]
    else:
        x = (o[:, None] + d[:, None] * m.ts[..., None]).reshape(-1, 3)
        valid = m.valid.reshape(-1)
    return torch.clamp(x, -1.0, 1.0), valid, K, M


def check_grid_encoder(spec, x, valid, label, gen, timed: bool):
    """Kernel A against its plain version on positions x; samples that are
    not valid (past a ray's last sample) get a zero cotangent, as in the
    train step, and the kernel skips them. Returns the entry's numbers and
    the kernel's inputs."""
    from dreamfusion_torch.ops import grid_encoder as ge

    consts = ge._level_consts(spec, x.device)
    base, w, _ = spec.residuals(x)
    L, J = base.shape
    cot = torch.randn(J, L, 2, device=x.device, generator=gen)
    if valid is not None:
        cot = cot * valid[:, None, None]
    n_live = J if valid is None else int(valid.sum())
    d_k = ge.grid_encoder_bwd_cuda(base, w, cot, consts)
    d_p = ge.grid_encoder_bwd_plain(base, w, cot, consts)
    torch.cuda.synchronize()
    # both sides sum with atomics in no fixed order; the coarsest level
    # takes ~200 updates per table entry at the main path's J
    err = float((d_k - d_p).abs().max())
    tol = 2e-5 * float(d_p.abs().max())
    log(f"[kernels] A grid_encoder_bwd {label}: L={L} J={J:,} (valid "
        f"{n_live:,}) T={consts.total:,}; max_abs_err {err:.3e} (tol {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"kernel A disagrees with index_add_ ({label})")
    inputs = (base, w, cot, consts)
    if not timed:
        return None, inputs
    kernel = lambda: ge.grid_encoder_bwd_cuda(base, w, cot, consts)  # noqa: E731
    ms = cuda_ms(kernel)
    dev_ms = device_ms(kernel)
    plain_ms = cuda_ms(lambda: ge.grid_encoder_bwd_plain(base, w, cot, consts),
                       reps=5)
    rows = torch.cat([ge._corner_rows(consts, base, l) for l in range(L)])
    upd = torch.cat([w[l][..., None] * cot[:, l][None] for l in range(L)])
    rows, upd = rows.reshape(-1), upd.reshape(-1, 2)
    out = torch.zeros(consts.total, 2, device=x.device)
    lib_ms = cuda_ms(lambda: out.index_add_(0, rows, upd))
    # every cotangent is read; rows and weights only for valid samples
    nbytes = L * J * 8 + L * n_live * (4 + 32) + consts.total * 2 * 4
    b_ms, b_by = bound(nbytes, L * n_live * 32)
    log(f"[kernels] A times ({label}): kernel {ms:.4f} ms ({b_ms / ms:.3f} "
        f"of its bound; device time {dev_ms:.4f} ms, the table's zeroing "
        f"included), plain {plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms "
        f"(kernel / index_add_ {ms / lib_ms:.3f}), bound {b_ms:.4f} ms "
        f"({b_by})")
    return ({"shape": f"{label}: L={L} J={J} T={consts.total}",
             "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": lib_ms}, inputs)


def grid_encoder_aggregation(base, cot):
    """Per level, over the 32-sample warps with a live sample: the mean
    number of distinct corner-0 rows (match groups) and of contiguous runs
    of one row (the updates kernel A issues per corner) among the live
    lanes."""
    L, J = base.shape
    pad = -J % 32
    live = torch.nn.functional.pad(cot.abs().sum(-1).t() > 0, (0, pad))
    key = torch.nn.functional.pad(base.long(), (0, pad))
    key = torch.where(live, key, -1).reshape(L, -1, 32)
    live = live.reshape(L, -1, 32)
    warps = live.any(-1)                                      # [L, W]
    srt = key.sort(-1).values
    distinct = ((srt[..., 1:] != srt[..., :-1]) & (srt[..., 1:] >= 0)).sum(-1) \
        + (srt[..., 0] >= 0)
    runs = ((key[..., 1:] != key[..., :-1]) & live[..., 1:]).sum(-1) \
        + live[..., 0]
    n = warps.sum(-1).clamp_min(1)
    return ((distinct * warps).sum(-1) / n).tolist(), \
        ((runs * warps).sum(-1) / n).tolist()


def check_grid_encoder_fwd(spec, emb, x, label):
    """Kernel H (the encoder's forward, all levels in one launch) against
    its plain version on the card (the gather and blend level by level)
    on positions x: within 1e-6 of the
    table's largest magnitude (the rows and weights are the plain
    version's bit for bit; the 8-term sum may be taken in another order),
    out-of-box rows exactly 0. Device times and launches of both
    (torch.profiler); byte bound: the positions in and the features out,
    each once (the table's rows come from L2)."""
    from dreamfusion_torch.ops import grid_encoder as ge

    B, L = x.shape[0], spec.num_levels

    def plain():
        xT, oob = spec._unit_positions(x, 1.0)
        return torch.where(oob[:, None, None], 0.0,
                           spec._gather_levels(emb, xT))

    kernel = lambda: ge.grid_encoder_fwd_cuda(spec, emb, x, 1.0)  # noqa: E731
    out, ref = kernel(), plain()
    oob = (x.abs() > 1.0).any(-1)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    tol = 1e-6 * float(emb.float().abs().max())
    log(f"[kernels] H grid_encoder_fwd {label}: L={L} B={B:,} ({int(oob.sum()):,} "
        f"outside the box) T={spec.table_size:,} {emb.dtype} table; "
        f"max_abs_err {err:.3e} (tol {tol:.3e})")
    if not err <= tol or bool(out[oob].any()):
        raise AssertionError(f"kernel H disagrees with its plain version "
                             f"({label})")
    ms, launches = device_time_and_launches(kernel)
    plain_ms, plain_launches = device_time_and_launches(plain, reps=3,
                                                        warmup=1)
    nbytes = B * 12 + B * L * 8
    b_ms, b_by = bound(nbytes, 0)
    log(f"[kernels] H times ({label}): kernel {ms:.4f} ms ({launches} device "
        f"launches a call; CUDA events over 20 calls {cuda_ms(kernel):.4f} "
        f"ms), plain {plain_ms:.4f} ms in {plain_launches} launches, bound "
        f"{b_ms:.5f} ms ({b_by}; {b_ms / ms:.3f} of it)")
    return {"shape": f"{label}: L={L} B={B} T={spec.table_size} {emb.dtype}",
            "max_abs_err": err, "ms": ms, "launches_a_call": launches,
            "plain_ms": plain_ms, "plain_launches_a_call": plain_launches,
            "bound_ms": b_ms, "bound_by": b_by}


def check_grid_encoder_rows(spec, x, label, gen, timed: bool):
    """Kernel E (corners, weights and rows formed in the kernel from the
    unit positions) against its plain version (spec.corner_rows, then
    index_add_ per level and corner) on positions x; samples outside the
    box get a zero cotangent, as the encoder's backward gives them, and the
    kernel skips them."""
    from dreamfusion_torch.ops import grid_encoder as ge

    xT, oob = spec._unit_positions(x, 1.0)
    x01 = xT.t()
    L, J, T = spec.num_levels, x01.shape[0], spec.table_size
    cot = torch.randn(J, L, 2, device=x.device, generator=gen)
    cot = cot * (~oob)[:, None, None]
    n_live = int((~oob).sum())
    d_k = ge.grid_encoder_bwd_rows_cuda(spec, x01, cot)
    rows, w = spec.corner_rows(x01)
    d_p = ge.grid_encoder_bwd_rows_plain(rows, w, cot, T)
    torch.cuda.synchronize()
    # both sides sum in f32 with atomics in no fixed order
    err = float((d_k - d_p).abs().max())
    tol = 2e-5 * float(d_p.abs().max())
    log(f"[kernels] E grid_encoder_bwd_rows {label}: L={L} J={J:,} (inside "
        f"the box {n_live:,}) T={T:,} max_abs_err {err:.3e} (tol {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"kernel E disagrees with its plain version ({label})")
    if not timed:
        return None
    kernel = lambda: ge.grid_encoder_bwd_rows_cuda(spec, x01, cot)  # noqa: E731
    ms = cuda_ms(kernel)
    dev_ms = device_ms(kernel)
    plain_ms = cuda_ms(lambda: ge.grid_encoder_bwd_rows_plain(
        *spec.corner_rows(x01), cot, T), reps=3, warmup=1)
    # the kernel's atomics, at most: 8 a live (sample, level), less one for
    # each pair of x-neighbour corners whose rows share 16 bytes (float4);
    # on affine levels lanes of one cell issue one set
    inside = rows[:, :, ~oob].long()
    n_ops = L * n_live * 8 - int(((inside[:, 0::2] ^ inside[:, 1::2]) == 1).sum())
    del inside
    flat_rows = rows.reshape(-1).long()
    upd = (w[..., None] * cot.permute(1, 0, 2)[:, None]).reshape(-1, 2)
    del rows, w
    out = torch.zeros(T, 2, device=x.device)
    lib_ms = cuda_ms(lambda: out.index_add_(0, flat_rows, upd), reps=5,
                     warmup=1)
    # x01 and every cotangent read once, the table written once
    nbytes = J * 12 + L * J * 8 + T * 2 * 4
    updates = L * n_live * 8
    b_ms, b_by = bound(nbytes, updates * 2)
    log(f"[kernels] E times ({label}): kernel {ms:.4f} ms by CUDA events, "
        f"{dev_ms:.4f} ms of device time (the table's zeroing included), "
        f"plain {plain_ms:.4f} ms, one index_add_ over all "
        f"{flat_rows.shape[0]:,} rows {lib_ms:.4f} ms (kernel / index_add_ "
        f"{ms / lib_ms:.3f}), bound {b_ms:.4f} ms ({b_by}; {b_ms / ms:.3f} "
        f"of it); {updates:,} row updates, {updates / ms / 1e6:.1f} G/s, in "
        f"at most {n_ops:,} atomics, {n_ops / ms / 1e6:.1f} G/s")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "row_updates": updates, "atomics": n_ops}


def composite_inputs(N, K, gen, device):
    """Rays of a 512-step lattice (dt = 2 sqrt(3) / 512) with an invalid
    tail; half the rays dense enough to cross T_thresh = 1e-4."""
    dt0 = 2.0 * math.sqrt(3.0) / 512
    u = lambda *s: torch.rand(*s, generator=gen, device=device)
    dense = (torch.arange(N, device=device) % 2 == 0).float()[:, None]
    sig = u(N, K) * (20.0 + 2000.0 * dense)
    n_valid = (u(N, 1) * K).long() + 1
    valid = (torch.arange(K, device=device)[None] < n_valid).float()
    sig = sig * valid
    dt = torch.full((N, K), dt0, device=device) * valid
    ts = (0.5 + dt0 * torch.arange(K, device=device).float()).expand(N, K)
    rgb = u(N, K, 3)
    g = (torch.randn(N, generator=gen, device=device),
         torch.randn(N, generator=gen, device=device),
         torch.randn(N, 3, generator=gen, device=device))
    return sig.contiguous(), rgb, dt, ts.contiguous(), g


def check_composite(N, K, gen, device, timed: bool):
    from dreamfusion_torch.ops import fused_composite as fc

    T = 1e-4
    sig, rgb, dt, ts, (gws, gd, gc) = composite_inputs(N, K, gen, device)
    ok = fc.composite_fwd_cuda(sig, rgb, dt, ts, T)
    op = fc.composite_fwd_plain(sig, rgb, dt, ts, T)
    bk = fc.composite_bwd_cuda(sig, rgb, dt, ts, gws, gd, gc, T)
    bp = fc.composite_bwd_plain(sig, rgb, dt, ts, gws, gd, gc, T)
    torch.cuda.synchronize()
    trans = torch.exp(torch.cumsum(-sig * dt, -1) + sig * dt)   # exclusive
    live = int((trans > T).sum())
    crossing = int(((trans <= T).any(-1)).sum())
    e_f = max(float((a - b).abs().max()) for a, b in zip(ok, op))
    e_b = max(float((a - b).abs().max()) for a, b in zip(bk, bp))
    tol_b = 1e-4 * max(float(bp[0].abs().max()), float(bp[1].abs().max()))
    log(f"[kernels] B N={N} K={K}: rays crossing T_thresh {crossing}, live "
        f"samples {live:,}; fwd max_abs_err {e_f:.3e} (tol 1e-5), bwd "
        f"max_abs_err {e_b:.3e} (tol {tol_b:.3e})")
    if not (e_f <= 1e-5 and e_b <= tol_b and crossing > 0):
        raise AssertionError(f"kernel B disagrees with its plain version (K={K})")
    if not timed:
        return None
    fwd = lambda: fc.composite_fwd_cuda(sig, rgb, dt, ts, T)  # noqa: E731
    bwd = lambda: fc.composite_bwd_cuda(sig, rgb, dt, ts, gws, gd, gc, T)  # noqa: E731
    f_ms, f_dev = cuda_ms(fwd), device_ms(fwd)
    f_plain = cuda_ms(lambda: fc.composite_fwd_plain(sig, rgb, dt, ts, T))
    b_ms, b_dev = cuda_ms(bwd), device_ms(bwd)
    b_plain = cuda_ms(lambda: fc.composite_bwd_plain(sig, rgb, dt, ts, gws, gd,
                                                     gc, T))
    fb, fby = bound(live * 24 + N * 20, live * 14)
    bb, bby = bound(live * 24 + N * 20 + N * K * 16, live * 40)
    log(f"[kernels] B-fwd {f_ms:.4f} ms by CUDA events over 20 launches, "
        f"{f_dev:.4f} ms of device time (torch.profiler) (plain "
        f"{f_plain:.4f}, bound {fb:.5f} {fby}); B-bwd {b_ms:.4f} ms by CUDA "
        f"events, {b_dev:.4f} ms of device time (plain {b_plain:.4f}, bound "
        f"{bb:.5f} {bby}; {bb / b_dev:.3f} of it)")
    # "ms" is the device time: at this size CUDA events read the host's
    # issue time
    return ({"max_abs_err": e_f, "ms": f_dev, "events_ms": f_ms,
             "plain_ms": f_plain,
             "bound_ms": fb, "bound_by": fby, "library_ms": None},
            {"max_abs_err": e_b, "ms": b_dev, "events_ms": b_ms,
             "plain_ms": b_plain,
             "bound_ms": bb, "bound_by": bby, "library_ms": None})


def crossing_rays(N, K, T_thresh, device):
    """Rays on the 512-step lattice whose T at one sample k* (7, 40, 77 or
    120 by n % 4: lanes of chunks 0-3) is swept across T_thresh in single
    ulps of the sigma before it (~0.4 ulp of log T a ray); sample 0 has
    alpha ~0.9, alpha at k* is ~0.05, and every sigma is > 0, after k* too.
    The construction of tests/test_torch_cuda.py::
    test_fused_composite_masks_agree_across_the_crossing."""
    f32 = np.float32
    rng = np.random.default_rng(13)
    dt0 = f32(2 * math.sqrt(3) / 512)
    kstar = np.array([7, 40, 77, 120])[np.arange(N) % 4]
    sd = rng.uniform(0.1, 0.5, (N, K))
    sd[:, 0] = 2.3
    rows = np.arange(N)
    sd[rows, kstar] = 0.0513

    def log_terms(s):
        a = (f32(1) - np.exp(-(s * dt0).astype(f32))).astype(f32)
        return np.log((f32(1) - a + f32(1e-15)).astype(f32)).astype(np.float64)

    sig = (sd / dt0).astype(f32)
    for k in np.unique(kstar):
        sel = kstar == k
        sig[np.ix_(sel, np.arange(1, k - 1))] = f32(
            (-math.log(T_thresh) - 2.3 - 4.0) / (k - 2) / dt0)
        need = math.log(T_thresh) - log_terms(sig[sel, :k - 1]).sum(1)
        sig[sel, k - 1] = (-need / dt0).astype(f32)
    step = (rows // 4 - N // 8).astype(np.int32)
    sig[rows, kstar - 1] = (sig[rows, kstar - 1].view(np.int32) + step).view(f32)
    sig = torch.from_numpy(sig).to(device)
    dt = torch.full((N, K), float(dt0), device=device)
    ts = (torch.cumsum(dt, -1) + 0.3).contiguous()
    rgb = torch.rand(N, K, 3, device=device,
                     generator=torch.Generator(device=device).manual_seed(14))
    return sig, rgb, dt, ts, torch.from_numpy(kstar).to(device)


def check_composite_crossing(N, K, device):
    """B-bwd's mask against B-fwd's on rays that cross T_thresh within
    rounding: with g_rgb = (1, 0, 0) and g_ws = g_d = 0, B-bwd's d_rgb[...,
    0] is its w_k, and its sum over k must equal B-fwd's weights_sum to 1e-6
    on every ray (a sample masked in one kernel and live in the other moves
    it by alpha T = 5e-6). Also how many rays the plain version (log T by
    torch.cumsum, another order) masks otherwise at k*."""
    from dreamfusion_torch.ops import fused_composite as fc

    T = 1e-4
    sig, rgb, dt, ts, kstar = crossing_rays(N, K, T, device)
    z = torch.zeros(N, device=device)
    gc = torch.zeros(N, 3, device=device)
    gc[:, 0] = 1.0
    ws, _, _ = fc.composite_fwd_cuda(sig, rgb, dt, ts, T)
    _, d_rgb = fc.composite_bwd_cuda(sig, rgb, dt, ts, z, z, gc, T)
    trans = fc._excl_log_trans(sig, dt)[1]
    torch.cuda.synchronize()
    rows = torch.arange(N, device=device)
    live_k = trans[rows, kstar] > T
    err = float((d_rgb[..., 0].sum(-1) - ws).abs().max())
    plain_differs = int(((d_rgb[..., 0] != 0) != (trans > T)).any(-1).sum())
    log(f"[kernels] B crossing N={N} K={K}: T at k* above T_thresh on "
        f"{int(live_k.sum())} of {N} rays (plain version); |sum_k B-bwd w_k "
        f"- B-fwd weights_sum| max {err:.3e} (tol 1e-6); rays the plain "
        f"version masks otherwise: {plain_differs}")
    if not (err <= 1e-6 and live_k.any() and not live_k.all()
            and bool((sig > 0).all())):
        raise AssertionError("B-bwd's mask differs from B-fwd's on the "
                             "crossing rays")


def check_attention(B, N, H, D, gen, device, grad: bool):
    """Flash-attention kernels against attention_plain (f32 scores and
    softmax) at one of the main path's shapes, bf16 inputs; times beside
    scaled_dot_product_attention on the same inputs (the port never calls
    it), with the achieved TFLOP/s of the operations the function needs
    (4 N^2 D a head forward, 10 N^2 D backward)."""
    from dreamfusion_torch.ops import flash_attention as fa

    scale = 1.0 / math.sqrt(D)
    # q at 3x unit variance: scores of std ~3, so the softmax is peaked
    q, k, v, do = (torch.randn(B, N, H, D, generator=gen, device=device)
                   .mul(m).to(torch.bfloat16) for m in (3.0, 1.0, 1.0, 1.0))
    o, lse = fa.attention_fwd_cuda(q, k, v, scale)
    qf, kf, vf = (x.float().requires_grad_(grad) for x in (q, k, v))
    o_ref = fa.attention_plain(qf, kf, vf, scale)
    o_ref_d = o_ref.detach()
    torch.cuda.synchronize()
    # bf16 output: half an ulp of bf16 is 2^-9 of a value; P enters the
    # second product in bf16 too. Tolerance 1e-2 of the largest entry.
    e_f = float((o.float() - o_ref_d).abs().max())
    tol_f = 1e-2 * float(o_ref_d.abs().max())
    label = f"B={B} N={N} H={H} D={D}"
    log(f"[kernels] attention_fwd {label}: max_abs_err {e_f:.3e} (tol "
        f"{tol_f:.3e})")
    if not e_f <= tol_f:
        raise AssertionError(f"attention_fwd disagrees with its plain version ({label})")
    flops = 4 * B * H * N * N * D
    nbytes = 4 * B * N * H * D * 2 + B * H * N * 4
    fb, fby = bound(nbytes, flops, H100_BF16_FLOPS)
    res = {"fwd": {
        "max_abs_err": e_f,
        "ms": cuda_ms(lambda: fa.attention_fwd_cuda(q, k, v, scale)),
        "plain_ms": cuda_ms(lambda: fa.attention_plain(q, k, v, scale), reps=5),
        "bound_ms": fb, "bound_by": fby,
        "library_ms": cuda_ms(lambda: torch.nn.functional
                              .scaled_dot_product_attention(
                                  q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), scale=scale))}}
    if grad:
        dq, dk, dv = fa.attention_bwd_cuda(q, k, v, o, lse, do, scale)
        refs = torch.autograd.grad(o_ref, (qf, kf, vf), do.float(),
                                   retain_graph=True)
        torch.cuda.synchronize()
        # dS = P (dP - delta) enters two products in bf16; the outputs are
        # bf16. Tolerance 2e-2 of each gradient's largest entry.
        errs = [float((g.float() - r).abs().max()) / float(r.abs().max())
                for g, r in zip((dq, dk, dv), refs)]
        log(f"[kernels] attention_bwd {label}: max_abs_err / max |ref| "
            f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (tol 2e-2)")
        if not max(errs) <= 2e-2:
            raise AssertionError(f"attention_bwd disagrees with its plain "
                                 f"version ({label})")
        e_b = max(float((g.float() - r).abs().max())
                  for g, r in zip((dq, dk, dv), refs))
        ql, kl, vl = (x.detach().requires_grad_(True) for x in (q, k, v))
        lib_o = torch.nn.functional.scaled_dot_product_attention(
            ql.transpose(1, 2), kl.transpose(1, 2), vl.transpose(1, 2),
            scale=scale)
        g_lib = do.transpose(1, 2)
        bb, bby = bound(8 * B * N * H * D * 2 + B * H * N * 4, 2.5 * flops,
                        H100_BF16_FLOPS)
        res["bwd"] = {
            "max_abs_err": e_b,
            "ms": cuda_ms(lambda: fa.attention_bwd_cuda(q, k, v, o, lse, do,
                                                        scale)),
            "plain_ms": cuda_ms(lambda: torch.autograd.grad(
                o_ref, (qf, kf, vf), do.float(), retain_graph=True), reps=5),
            "bound_ms": bb, "bound_by": bby,
            "library_ms": cuda_ms(lambda: torch.autograd.grad(
                lib_o, (ql, kl, vl), g_lib, retain_graph=True))}
    for key, r in res.items():
        f = flops * (2.5 if key == "bwd" else 1)
        r["shape"] = label
        log(f"[kernels] attention_{key} {label}: kernel {r['ms']:.4f} ms "
            f"({f / r['ms'] / 1e9:.1f} TFLOP/s), plain {r['plain_ms']:.4f} "
            f"ms, scaled_dot_product_attention {r['library_ms']:.4f} ms "
            f"({f / r['library_ms'] / 1e9:.1f} TFLOP/s), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
            f"{r['bound_ms'] / r['ms']:.3f} of it)")
    return res


def check_composite_compact(samples, cmap, N, T_thresh, label):
    """Kernel C (the compact compositor) against composite_compact_plain
    (the two-pass flat cumsum, then index_add_) at one of the eval's
    compact budgets. l is log(1 - alpha + 1e-15) in the kernel and
    log(exp(-tau) + 1e-15) in the plain version, summed in another order:
    values 1e-5 of the largest per-ray sum, plus one sample's alpha T (<=
    T_thresh; times t or the colour) on a ray whose live count differs;
    live counts differ by at most 1, on at most 0.1% of the rays. The
    plain version runs on the CPU copy of the inputs, where its flat f32
    cumsum over the whole budget is sequential: the card's parallel scan
    drifts further (its difference is printed)."""
    from dreamfusion_torch.ops import fused_composite as fc
    from dreamfusion_torch.ops import marching

    cpu = torch.device("cpu")
    got = fc.composite_compact_cuda(*samples, cmap, N, T_thresh)
    on_card = marching.composite_compact_plain(*samples, cmap, N, T_thresh)
    sig, col, t, dt = (x.to(cpu) for x in samples)
    ref = marching.composite_compact_plain(
        sig, col, t, dt, marching.CompactMap(*(x.to(cpu) for x in cmap)), N,
        T_thresh)
    got, on_card = ([x.to(cpu) for x in r] for r in (got, on_card))
    card_drift = max(float((a - b).abs().max())
                     for a, b in zip(on_card[:3], ref[:3]))
    M = sig.shape[0]
    differ = got[3] != ref[3]
    n_diff, d_max = int(differ.sum()), float((got[3] - ref[3]).abs().max())
    err, ok = 0.0, n_diff <= 0.001 * N and d_max <= 1
    for a, b, factor in ((got[0], ref[0], float(col.abs().max())),
                         (got[1], ref[1], 1.0),
                         (got[2], ref[2], float(t.abs().max()))):
        a, b = a.reshape(N, -1), b.reshape(N, -1)
        gap = (a - b).abs()
        tol = 1e-5 * b.abs().max() + differ[:, None] * 1.01 * T_thresh * factor
        err = max(err, float(gap.max()))
        ok = ok and bool((gap <= tol).all())
    live = float(ref[3].sum())
    log(f"[kernels] C composite_compact {label}: M={M:,} N={N:,} "
        f"T_thresh={T_thresh:g}, live samples {live:,.0f}; max_abs_err "
        f"{err:.3e} (tol 1e-5 of the largest sum, plus alpha T on a ray "
        f"whose live count differs); live counts differ on {n_diff} of {N} "
        f"rays, by at most {d_max:g}; the plain version on the card against "
        f"it on the CPU: max abs diff {card_drift:.3e} (registers and spills: "
        f"the [build] lines)")
    if not ok:
        raise AssertionError(f"kernel C disagrees with its plain version "
                             f"({label})")
    kernel = lambda: fc.composite_compact_cuda(  # noqa: E731
        *samples, cmap, N, T_thresh)
    plain = lambda: marching.composite_compact_plain(  # noqa: E731
        *samples, cmap, N, T_thresh)
    ms, launches = device_time_and_launches(kernel)
    plain_ms, plain_launches = device_time_and_launches(plain)
    # the samples up to each ray's cut read once, the segments and the
    # rows once
    b_ms, b_by = bound(live * 24 + N * (16 + 24), live * 14)
    log(f"[kernels] C device times ({label}): kernel {ms:.4f} ms in "
        f"{launches} launch a call ({b_ms / ms:.3f} of its bound), "
        f"plain (the TPU form's prologue and index_add_) {plain_ms:.4f} ms "
        f"in {plain_launches} launches a call, bound {b_ms:.5f} ms "
        f"({b_by}); with every sample of the budget read, "
        f"{bound(M * 24 + N * 40, 0)[0]:.5f} ms; CUDA events over 20 calls "
        f"{cuda_ms(kernel):.4f} ms a call")
    return {"shape": f"{label}: M={M} N={N}", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "plain_launches": plain_launches,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "live_counts_differ": n_diff, "plain_on_card_err": card_drift}


def check_compact_vs_b_fwd(samples, cmap, N, T_thresh, label):
    """Kernel C against kernel B-fwd on compact_expand of the same buffer:
    chunk k of a segment is chunk k of the expanded ray and the dropped
    slots read sigma = delta = 0 (l = 0, w = 0), so both walk the same T
    bits. Per ray, the samples with w > 0 must be as many in both: in B,
    those where B-bwd's d_rgb is > 0 for g_rgb = (1, 0, 0) (B-bwd's mask is
    B-fwd's bit for bit); in C, its live prefix less the samples whose
    alpha is 0. weights_sum, depth and rgb to 1e-6; whether they are the
    same bits is printed."""
    from dreamfusion_torch.ops import fused_composite as fc
    from dreamfusion_torch.ops import marching

    rgb_c, ws_c, dep_c, live = fc.composite_compact_cuda(
        *samples, cmap, N, T_thresh)
    sig, col, t, dt = (marching.compact_expand(x, cmap).contiguous()
                       for x in samples)
    ws, dep, rgb = fc.composite_fwd_cuda(sig, col, dt, t, T_thresh)
    z = torch.zeros(N, device=sig.device)
    g_rgb = torch.zeros(N, 3, device=sig.device)
    g_rgb[:, 0] = 1.0
    _, d_rgb = fc.composite_bwd_cuda(sig, col, dt, t, z, z, g_rgb, T_thresh)
    torch.cuda.synchronize()
    K = sig.shape[1]
    prefix = torch.arange(K, device=sig.device)[None, :] < live[:, None]
    alpha_zero = torch.exp(-(sig * dt)) == 1.0
    w_pos_c = (prefix & ~alpha_zero).sum(1)
    w_pos_b = (d_rgb[..., 0] > 0).sum(1)
    pairs = ((ws_c, ws), (dep_c, dep), (rgb_c, rgb))
    err = max(float((a - b).abs().max()) for a, b in pairs)
    same = all(torch.equal(a, b) for a, b in pairs)
    n_diff = int((w_pos_c != w_pos_b).sum())
    log(f"[kernels] C vs B-fwd on compact_expand ({label}): rays whose "
        f"count of samples with w > 0 differs {n_diff} of {N} (live samples "
        f"with alpha 0: {int((prefix & alpha_zero).sum())}); weights_sum, "
        f"depth, rgb max abs diff {err:.3e} (tol 1e-6), "
        f"{'bitwise equal' if same else 'not bitwise equal'}")
    if n_diff or not err <= 1e-6:
        raise AssertionError(f"kernel C's mask or sums differ from B-fwd's "
                             f"({label})")
    return same


def check_compact_crossing(N, K, device):
    """Kernel C against B-fwd on the crossing rays (crossing_rays: T at
    sample k* swept across T_thresh in single ulps of sigma) laid out
    compactly, each ray keeping a seeded count of samples in (k*, K]."""
    from dreamfusion_torch.ops import marching

    T = 1e-4
    sig, rgb, dt, ts, kstar = crossing_rays(N, K, T, device)
    g = torch.Generator(device=device).manual_seed(16)
    cnt = kstar + 1 + (torch.rand(N, device=device, generator=g)
                       * (K - kstar)).long()
    cmap = marching.make_compact_map(cnt, K, int(cnt.sum()))
    keep = torch.arange(K, device=device)[None, :] < cnt[:, None]
    samples = tuple(x[keep].contiguous() for x in (sig, rgb, ts, dt))
    return check_compact_vs_b_fwd(samples, cmap, N, T,
                                  f"crossing rays, cnt {int(cnt.min())}-"
                                  f"{int(cnt.max())}")


def check_probe(table, idx):
    """Kernel D against the element gather (its plain version), exact."""
    from dreamfusion_torch.ops import probe

    got = probe.probe_select_small_cuda(table, idx)
    ref = probe.probe_select_small_plain(table, idx)
    torch.cuda.synchronize()
    err = float((got.int() - ref.int()).abs().max())
    T, J = table.shape[0], idx.shape[0]
    log(f"[kernels] D probe_select_small: J={J:,} probes, T={T:,} "
        f"({float(table.float().mean()):.4f} set), max_abs_err {err:g} "
        f"(exact)")
    if err != 0.0:
        raise AssertionError("kernel D disagrees with the element gather")
    b_ms, b_by = bound(J * (4 + 1) + T, 0)
    kernel = lambda: probe.probe_select_small_cuda(table, idx)  # noqa: E731
    res = {"max_abs_err": err, "ms": device_ms(kernel),
           "plain_ms": device_ms(lambda: probe.probe_select_small_plain(
               table, idx)),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": device_ms(lambda: torch.index_select(table, 0, idx))}
    log(f"[kernels] D device times: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, index_select {res['library_ms']:.4f} ms, "
        f"bound {b_ms:.5f} ms ({b_by}); CUDA events over 20 calls "
        f"{cuda_ms(kernel):.4f} ms a call")
    return res


def ball_ring_rays(n_rays: int, seed: int, size: int = 400):
    """n_rays training rays of the ball scene's 100 train views
    (write_ball_scene's cameras, size^2 pixels), each ray's view and pixel
    drawn from the seed: (rays_d, rays_o, viewdirs, target) float32 numpy
    [n_rays, 3], the order DVGO's ray loader yields; target the ball's
    colour on white."""
    c2ws = _ball_poses(100, np.random.RandomState(0))
    focal = 0.5 * size / math.tan(0.5 * BLENDER_ANGLE_X)
    rng = np.random.RandomState(seed % 2 ** 32)
    view = rng.randint(0, len(c2ws), n_rays)
    px = rng.randint(0, size, n_rays) + 0.5
    py = rng.randint(0, size, n_rays) + 0.5
    dirs = np.stack([(px - 0.5 * size) / focal, -(py - 0.5 * size) / focal,
                     -np.ones(n_rays)], -1)
    rays_d = np.einsum("nij,nj->ni", c2ws[view, :3, :3], dirs)
    rays_o = c2ws[view, :3, 3]
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rgb, hit = _ball_colour(rays_o, viewdirs)
    target = np.where(hit[:, None], rgb, 1.0)
    return tuple(a.astype(np.float32)
                 for a in (rays_d, rays_o, viewdirs, target))


def dvgo_ring_samples(n_rays: int, seed: int, device="cuda"):
    """(x01 [n_rays * 954, 3], out-of-box mask [n_rays * 954]) of
    ball_ring_rays sampled as DVGO's fine field samples them in pretraining
    (near 2, far 6, box +-1, 159^3 voxels, stepsize 0.5, 954 samples a ray,
    ray jitter): most samples lie past the box and clamp onto its faces,
    edges and corners."""
    from dreamfusion_torch.models.dvgo import sample_ray

    dev = torch.device(device)
    rays_d, rays_o = (torch.from_numpy(a).to(dev)
                      for a in ball_ring_rays(n_rays, seed)[:2])
    lo = torch.full((3,), -1.0, device=dev)
    hi = torch.full((3,), 1.0, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    pts, oob = sample_ray(rays_o, rays_d, near=2.0, far=6.0, xyz_min=lo,
                          xyz_max=hi, voxel_size=2 / 159, stepsize=0.5,
                          n_samples=954,
                          jitter=torch.rand(n_rays, 1, device=dev,
                                            generator=g))
    return ((pts - lo) / (hi - lo)).reshape(-1, 3).contiguous(), \
        oob.reshape(-1)


def check_grid_sample(label, C, x01, live, gen):
    """Kernel G (grid_sample_fwd, grid_sample_bwd) at a [C, 159^3] grid
    against the plain gather: the forward within 1e-6 and the gradient
    within 1e-5 of their largest entries (atomics add in another order),
    and so the deterministic mode's ordered backward
    (grid_sample_bwd_ordered). Device times (torch.profiler,
    device_time_and_launches) of both kernels (the backward with the
    gradient's zeroing), the ordered backward, the plain forward and its
    autograd backward, and F.grid_sample (padding "border", the same clamp)
    forward and backward; byte bounds: positions and output (forward); the
    cotangent, the positions of the samples whose cotangent is live and the
    dense gradient (backward)."""
    import torch.nn.functional as F

    from dreamfusion_torch.ops import grid_sample as gs

    dev, B = x01.device, x01.shape[0]
    grid = torch.randn(C, 159, 159, 159, device=dev, generator=gen)
    cot = torch.where(live[:, None], torch.randn(B, C, device=dev,
                                                 generator=gen), 0.0)
    out = gs.grid_sample_fwd_cuda(grid, x01)
    d = gs.grid_sample_bwd_cuda(x01, cot, grid.shape)
    d_o = gs.grid_sample_bwd_ordered(x01, cot, grid.shape)
    gp = grid.clone().requires_grad_(True)
    out_p = gs.grid_sample_3d_plain(gp, x01)
    (d_p,) = torch.autograd.grad(out_p, gp, cot, retain_graph=True)
    torch.cuda.synchronize()
    fwd_err, bwd_err = rel_err(out, out_p.detach()), rel_err(d, d_p)
    ordered_err = rel_err(d_o, d_p)
    n_live = int(live.sum())
    skipped = 1.0 - n_live / B
    log(f"[kernels] G {label}: C={C}, B={B:,} samples, {skipped:.4f} of "
        f"them with an all-zero cotangent (skipped); forward rel err "
        f"{fwd_err:.3g} (1e-6), gradient {bwd_err:.3g} (1e-5), ordered "
        f"gradient {ordered_err:.3g} (1e-5)")
    if fwd_err > 1e-6 or bwd_err > 1e-5 or ordered_err > 1e-5:
        raise AssertionError(f"kernel G disagrees with the plain gather "
                             f"({label})")
    plain_b = lambda: torch.autograd.grad(  # noqa: E731
        out_p, gp, cot, retain_graph=True)
    gl = grid[None].clone().requires_grad_(True)
    ind = (x01 * 2 - 1).flip(-1).reshape(1, B, 1, 1, 3)
    lib_f = lambda: F.grid_sample(  # noqa: E731
        gl, ind, mode="bilinear", padding_mode="border", align_corners=True)
    out_l = lib_f()
    cot_l = cot.t().reshape(1, C, B, 1, 1)
    lib_b = lambda: torch.autograd.grad(  # noqa: E731
        out_l, gl, cot_l, retain_graph=True)
    res = {}
    for way, kernel, plain, lib, nbytes in (
            ("fwd", lambda: gs.grid_sample_fwd_cuda(grid, x01),
             lambda: gs.grid_sample_3d_plain(grid, x01), lib_f,
             B * (12 + 4 * C)),
            ("bwd", lambda: gs.grid_sample_bwd_cuda(x01, cot, grid.shape),
             plain_b, lib_b, n_live * 12 + B * 4 * C + grid.numel() * 4)):
        ms, launches = device_time_and_launches(kernel)
        b_ms, b_by = bound(nbytes, 0)
        r = {"max_rel_err": fwd_err if way == "fwd" else bwd_err, "ms": ms,
             "launches_a_call": launches, "plain_ms": device_ms(plain, reps=5),
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": device_ms(lib, reps=5), "skipped_share": skipped}
        ordered = ""
        if way == "bwd":
            r["ordered_ms"] = device_ms(lambda: gs.grid_sample_bwd_ordered(
                x01, cot, grid.shape), reps=5)
            ordered = f", ordered (deterministic mode) {r['ordered_ms']:.4f} ms"
        log(f"[kernels] G {label} {way}: kernel {ms:.4f} ms ({launches} "
            f"device launches a call), plain {r['plain_ms']:.4f} ms"
            f"{ordered}, F.grid_sample {r['library_ms']:.4f} ms, bound "
            f"{b_ms:.5f} ms ({b_by}); CUDA events over 20 calls "
            f"{cuda_ms(kernel):.4f} ms")
        res[way] = r
    return res


def cone_inputs(label, gs, rays_o, rays_d, cfg, perturb: bool, gen):
    """Kernel F's inputs for rays through grid state gs: (label, occ,
    rays_o, rays_d, t0, fars, bound, max_steps, K, dt_gamma), t0 the
    perturbed start where perturb, as march_rays computes it."""
    from dreamfusion_torch.ops import marching
    from dreamfusion_torch.ops.composite import near_far_from_aabb

    b = cfg.bound
    aabb = torch.tensor([-b] * 3 + [b] * 3, device=rays_o.device)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, cfg.min_near)
    t0 = nears
    if perturb:
        g, lo, hi, _ = marching.cone_constants(cfg.dt_gamma, cfg.max_steps,
                                               gs.occ.shape[0],
                                               gs.occ.shape[1])
        u = torch.rand(nears.shape, generator=gen, device=nears.device)
        t0 = nears + torch.clamp(nears * g, lo, hi) * u
    return (label, gs.occ, rays_o.contiguous(), rays_d.contiguous(),
            t0.contiguous(), fars.contiguous(), b, cfg.max_steps, cfg.grid_K,
            cfg.dt_gamma)


def check_march_cone(label, occ, o, d, t0, fars, bound_, max_steps, K,
                     dt_gamma, timed: bool):
    """Kernel F against march_rays_cone_plain on the card: counts, ts, dts
    and valid must be the same bits. Timed: CUDA events over 20 launches
    (the plain version, a host loop of max_steps steps with a device sync
    per sub-step, once), the byte bound of its rays in and [N, K] samples
    plus counts out."""
    from dreamfusion_torch.ops import marching

    kw = dict(bound=bound_, max_steps=max_steps, K=K, dt_gamma=dt_gamma)
    got = marching.march_rays_cone_cuda(occ, o, d, t0, fars, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ref = marching.march_rays_cone_plain(occ, o, d, t0, fars, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t1
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, ref))
    N = o.shape[0]
    c = ref.counts.float()
    log(f"[kernels] F {label}: N={N:,} rays, max_steps {max_steps}, K {K}, "
        f"dt_gamma {dt_gamma:g}, grid {tuple(occ.shape)} "
        f"({float(occ.float().mean()):.4f} set); emits mean {float(c.mean()):.2f}"
        f" max {int(c.max())}, rays over K {int((c > K).sum())}; bitwise "
        f"equal to the plain version: {same} (max_abs_err {diff:g})")
    if not same:
        bad = (got.counts != ref.counts).nonzero().flatten()[:5].tolist()
        raise AssertionError(f"kernel F differs from its plain version "
                             f"({label}); rays with other counts: {bad}")
    if not timed:
        return None
    ms = cuda_ms(lambda: marching.march_rays_cone_cuda(occ, o, d, t0, fars,
                                                      **kw))
    b_ms, b_by = bound(N * (24 + 4 + 4) + N * K * 9 + N * 8, 0)
    log(f"[kernels] F {label}: {ms:.4f} ms by CUDA events over 20 launches "
        f"(plain {plain_s * 1e3:.1f} ms, one run; bound {b_ms:.5f} ms "
        f"{b_by}, {b_ms / ms:.4f} of it)")
    return {"max_abs_err": diff, "ms": ms, "plain_ms": plain_s * 1e3,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def frame_march_args(cfg, model, gs, view: int = 3):
    """The arguments the staged eval hands marching.march_window_groups
    for orbit frame `view` of cfg.test_size at cfg.H x cfg.W: ((the grid
    state, the frame's padded rays, classify's perm, t_lo and span maxima,
    the number of flagged groups), the keywords). It records them by
    swapping the trainer module's name march_window_groups for the
    frame."""
    from dreamfusion_torch import cameras
    from dreamfusion_torch.training import trainer as tr_mod

    seen = {}
    march = tr_mod.march_window_groups

    def spy(*args, **kw):
        seen["args"], seen["kw"] = args, kw
        return march(*args, **kw)

    tr_mod.march_window_groups = spy
    try:
        b = cameras.sample_test_batch(view, cfg.test_size, cfg, H=cfg.H,
                                      W=cfg.W, device=gs.occ.device)
        tr_mod.make_staged_grid_eval(cfg, model, cfg.H, cfg.W)(
            b["rays_o"][0], b["rays_d"][0], gs)
    finally:
        tr_mod.march_window_groups = march
    return seen["args"], seen["kw"]


def orbit_scene(config: str, tmp: str):
    """An orbit cell's field and grid state at its configuration's settings
    (benchmark/configs/<config>.json's "trainer"): grid_sd15's seeded -O
    grid field, or dvgo_sd15's editing field on write_dvgo's seeded 160^3
    scene (written under tmp); one full refresh from a seeded jitter.
    Returns (cfg, model, grid state)."""
    from dreamfusion_torch.config import Config
    from dreamfusion_torch.models.networks import build_model
    from dreamfusion_torch.ops import marching

    dev = torch.device("cuda")
    with open(os.path.join(ROOT, "benchmark", "configs",
                           f"{config}.json")) as f:
        fields = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in json.load(f)["trainer"].items()}
    if fields["backbone"] == "dvgo":
        fields["pretrained_dvgo"] = os.path.join(tmp, "scene.dvgo")
        write_dvgo(fields["pretrained_dvgo"])
    cfg = Config().replace(**fields).replace(text="x", guidance="none")
    g = torch.Generator(device=dev).manual_seed(5)
    model = build_model(cfg, dev, g)
    if cfg.pretrained_dvgo:
        model.load_pretrained(cfg.pretrained_dvgo)
    jitter = torch.rand(cfg.cascade, cfg.grid_size ** 3, 3, device=dev,
                        generator=g)
    gs = marching.update_grid(
        model.density, marching.init_grid_state(cfg.cascade, cfg.grid_size,
                                                dev),
        bound=cfg.bound, density_thresh=cfg.density_thresh,
        decay=cfg.grid_decay, jitter=jitter)
    return cfg, model, gs


def compare_march_window(gs, got, gst, ref, rst, *, K: int,
                         live_logt: float, bound: float, label: str):
    """Kernel W's result (got, gst) against march_window_groups_plain's
    (ref, rst) for one call, as the card tests and the kernels phase hold
    it. Ray indices, o_g, d_g, nears, fars, ts, dts (so the emits) and
    gcount the same bits. valid differs only at slots whose exclusive
    optical depth (the plain version's: the probed sigma EMA summed in
    torch's cumsum order) lies within 1e-5 relative of live_logt, since
    the kernel's running sum is a warp scan; counts are the kernel's valid
    slots, glive and ltot their maximum and sum, and those equal the
    plain version's but for the flipped slots. Raises AssertionError;
    returns {"near_cut": slots within 1e-5 of the cut, "flipped": those on
    the other side, "cut_rays": rays the cut shortens, "full": rays with K
    emits}."""
    from dreamfusion_torch.ops import marching

    def need(ok, what):
        if not ok:
            raise AssertionError(f"kernel W against the torch march "
                                 f"({label}): {what}")

    need(len(got) == len(ref) == len(gst) == len(rst), "group counts")
    seen = dict(near_cut=0, flipped=0, cut_rays=0, full=0)
    for b, (gr, rr, gs_, rs) in enumerate(zip(got, ref, gst, rst)):
        need(all(torch.equal(x, y) for x, y in zip(gr[:3] + gr[4:],
                                                   rr[:3] + rr[4:])),
             f"group {b}: ray indices, o_g, d_g, nears or fars")
        mg, mr = gr[3], rr[3]
        need(torch.equal(mg.ts, mr.ts) and torch.equal(mg.dts, mr.dts),
             f"group {b}: ts or dts")
        need(gs_[1] == rs[1], f"group {b}: gcount {gs_[1]} != {rs[1]}")
        sig = marching.probe_density(gs.density_grid, rr[1], rr[2], mr.ts,
                                     bound)
        emitted = mr.dts > 0
        depth = torch.cumsum(torch.clamp(sig, min=0.0) * mr.dts * emitted, 1)
        ex = torch.cat([torch.zeros_like(depth[:, :1]), depth[:, :-1]], 1)
        close = emitted & ((ex - live_logt).abs() <= 1e-5 * live_logt)
        diff = mg.valid != mr.valid
        flipped = int(diff.sum())
        need(not (diff & ~close).any(),
             f"group {b}: valid differs away from the live cut")
        need(torch.equal(mg.counts, mg.valid.sum(1)),
             f"group {b}: counts are not the valid slots")
        need(gs_[0] == float(mg.counts.max())
             and gs_[2] == float(mg.counts.sum()),
             f"group {b}: glive, ltot {gs_} are not the counts'")
        need(abs(gs_[0] - rs[0]) <= flipped and abs(gs_[2] - rs[2]) <= flipped,
             f"group {b}: stats {gs_} != {rs} beyond {flipped} flipped")
        seen["near_cut"] += int(close.sum())
        seen["flipped"] += flipped
        seen["cut_rays"] += int((mr.valid.sum(1) < emitted.sum(1)).sum())
        seen["full"] += int((emitted.sum(1) == K).sum())
    return seen


def check_march_window(label, cfg, model, gs, view: int = 3):
    """Kernel W against march_window_groups_plain on the flagged groups of
    orbit frame `view` (frame_march_args), held as compare_march_window
    holds it. Timed: device ms and launches a call of both by
    torch.profiler; the byte bound of the rays and indices read once and
    the outputs written once."""
    from dreamfusion_torch.ops import marching

    args, kw = frame_march_args(cfg, model, gs, view)
    kernel = lambda: marching.march_window_groups_cuda(*args, **kw)  # noqa: E731
    plain = lambda: marching.march_window_groups_plain(*args, **kw)  # noqa: E731
    (got, gst), (ref, rst) = kernel(), plain()
    torch.cuda.synchronize()
    seen = compare_march_window(gs, got, gst, ref, rst, K=kw["K"],
                                live_logt=kw["live_logt"], bound=kw["bound"],
                                label=label)
    n, group, K = len(got), kw["group"], kw["K"]
    emits = sum(int((r[3].dts > 0).sum()) for r in ref)
    live = sum(s[2] for s in rst)
    gspan, G = args[5], args[5].shape[0]
    S = sorted({marching.window_length(s, kw["S_ladder"])
                for s in gspan[G - n:].tolist()})
    log(f"[kernels] W {label}: {n} groups of {group} rays, K {K}, S {S}; "
        f"{emits:,} emits, {live:,.0f} live; equal to the plain version "
        f"but at the live cut: {seen['near_cut']} slots within 1e-5 of it, "
        f"{seen['flipped']} on the other side; {seen['cut_rays']} rays cut, "
        f"{seen['full']} with K emits")
    ms, launches = device_time_and_launches(kernel)
    plain_ms, plain_launches = device_time_and_launches(plain, reps=3,
                                                        warmup=1)
    # read: rays, perm and t_lo (36 bytes a ray); written: o_g, d_g, near,
    # far, count (40 a ray) and ts, dts, valid (9 a slot)
    b_ms, b_by = bound(n * group * (36 + 40 + 9 * K), 0)
    log(f"[kernels] W {label}: {ms:.4f} device ms in {launches:g} launches "
        f"a call (the kernel, the stats' zeroing and transfer); plain "
        f"{plain_ms:.4f} in {plain_launches:g}; bound {b_ms:.5f} ms {b_by}, "
        f"{b_ms / ms:.4f} of it")
    return {"ms": ms, "launches_a_call": launches, "plain_ms": plain_ms,
            "plain_launches_a_call": plain_launches, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "groups": n,
            "flipped_slots": seen["flipped"]}


def _cone_cases(opt_trainer, gen):
    """Kernel F's inputs: the options phase's grid with a fresh jittered
    train batch (4,096 rays, perturbed) and a 4,096-ray chunk of its 800x800
    orbit frame 1 through the frame's middle; without that phase, the same
    shapes through a seeded ball grid at 128^3."""
    from dreamfusion_torch import cameras
    from dreamfusion_torch.config import parse_config
    from dreamfusion_torch.ops import marching

    dev = torch.device("cuda")
    if opt_trainer is not None:
        cfg, gs = opt_trainer.cfg, opt_trainer.grid_state
    else:
        cfg = parse_config(["-O", "--text", "x", "--dt_gamma", "0.0078125",
                            "--jitter_pose"])
        H = cfg.grid_size
        lin = (torch.arange(H, device=dev) + 0.5) / H * 2 - 1
        X, Y, Z = torch.meshgrid(lin, lin, lin, indexing="ij")
        occ = (torch.sqrt(X * X + Y * Y + Z * Z) < 0.5) | (
            torch.rand(H, H, H, device=dev, generator=gen) < 0.02)
        gs = marching.GridState(torch.zeros(1, H, H, H, device=dev),
                                occ[None].contiguous(),
                                torch.zeros((), device=dev))
    b = cameras.sample_train_batch(cfg, generator=gen, device=dev)
    o, d = b["rays_o"].reshape(-1, 3), b["rays_d"].reshape(-1, 3)
    tb = cameras.sample_test_batch(1, cfg.test_size, cfg, device=dev)
    s = cfg.H * cfg.W // 2 - cfg.max_ray_batch // 2
    eo = tb["rays_o"][0][s:s + cfg.max_ray_batch]
    ed = tb["rays_d"][0][s:s + cfg.max_ray_batch]
    return [cone_inputs("train shape (perturbed)", gs, o, d, cfg, True, gen),
            cone_inputs("eval chunk", gs, eo, ed, cfg, False, gen)]


# -- slice 10: txt2img, mesh export, GUI --------------------------------------------

TXT2IMG_RUNS = (("plms", 50), ("pndm", 6), ("ddim", 10))
# the decode held against the plain attention path: bf16 activations
# through the decoder's 15 resnets after the mid block's attention, so the
# flash route's bf16 rounding of P and of the output spreads; tolerance
# 3e-2 of the plain decode's largest entry. That residual path dilutes the
# attention's own output, so the mid block's attention output is also held
# alone, on the decode's own q, k and v: flash against f32 scores and
# softmax, to 3x the error of the plain bf16 path (layers.use_flash off) on
# the same inputs, the rounding control
DECODE_RTOL = 3e-2
MID_ATTN_CONTROL_X = 3.0


def phase_txt2img(guidance, size: int = 512):
    """prompt_to_img with `guidance`'s SD v1.5-wide models (random-full,
    bf16), size^2, CFG 7.5, through each sampler (TXT2IMG_RUNS: plms, pndm
    with its 3 PRK transfers, ddim): ms per UNet evaluation and per decode
    from CUDA events
    recorded by forward hooks, K5 launches in the UNet and in the decoder,
    peak memory, the decoded image finite and the uint8 image in [0, 255];
    then the last decode of the card's latents again with the plain
    attention path (layers.use_flash off), held to DECODE_RTOL, and the
    decoder's mid-block attention output of that decode held to
    MID_ATTN_CONTROL_X times its rounding control. Returns the launch
    counts of the three runs."""
    from dreamfusion_torch.guidance.sd import layers, pipeline
    from dreamfusion_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    unet, vae = guidance.modules["unet"], guidance.modules["vae"]
    log(f"[txt2img] SD random-full ({next(unet.parameters()).dtype}), "
        f"{size}x{size}, guidance 7.5; runs {TXT2IMG_RUNS}")
    rec = {"unet": [], "decoder": [], "captured": None}

    def pre(tag):
        def hook(module, args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            rec[tag].append([ev, None, kcuda.launch_counts["attention_fwd"]])
            if tag == "decoder":
                rec["captured"] = args[0].detach().clone()
        return hook

    def post(tag):
        def hook(module, args, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            rec[tag][-1][1] = ev
            rec[tag][-1][2] = (kcuda.launch_counts["attention_fwd"]
                               - rec[tag][-1][2])
            if tag == "decoder":
                rec["image"] = out.detach()
        return hook

    hooks = [unet.register_forward_pre_hook(pre("unet")),
             unet.register_forward_hook(post("unet")),
             vae.decoder.register_forward_pre_hook(pre("decoder")),
             vae.decoder.register_forward_hook(post("decoder"))]
    total = {k: 0 for k in kcuda.launch_counts}
    try:
        for sampler, steps in TXT2IMG_RUNS:
            rec["unet"].clear()
            rec["decoder"].clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kcuda.reset_counts()
            t0 = time.perf_counter()
            img = pipeline.prompt_to_img(
                "a DSLR photo of a corgi", sd_weights="random-full",
                height=size, width=size, num_inference_steps=steps,
                guidance_scale=7.5, seed=0, sampler=sampler,
                guidance=guidance, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(kcuda.launch_counts)
            for k, v in counts.items():
                total[k] += v
            u_ms = [s.elapsed_time(e) for s, e, _ in rec["unet"]]
            d_ms = [s.elapsed_time(e) for s, e, _ in rec["decoder"]]
            u_k5 = sum(n for _, _, n in rec["unet"])
            d_k5 = sum(n for _, _, n in rec["decoder"])
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            want = steps + 3 * pipeline.PRK_WARMUP if sampler == "pndm" \
                else steps
            log(f"[txt2img] {sampler} {steps} steps: wall {wall:.3f} s; "
                f"{len(u_ms)} UNet evals (B=2), mean {np.mean(u_ms):.2f} ms "
                f"(min {min(u_ms):.2f}, max {max(u_ms):.2f}; first "
                f"{u_ms[0]:.2f}); decode {d_ms[0]:.2f} ms; K5 launches "
                f"UNet {u_k5} ({u_k5 / len(u_ms):.0f} an eval), decoder "
                f"{d_k5}; peak device memory {peak:.2f} GiB")
            log(f"[txt2img] {sampler} kernels {json.dumps(counts)}")
            finite = bool(torch.isfinite(rec["image"]).all())
            if (img.shape != (1, size, size, 3) or img.dtype != np.uint8
                    or not finite or len(u_ms) != want or len(d_ms) != 1):
                raise AssertionError(
                    f"txt2img {sampler}: image {img.shape} {img.dtype}, "
                    f"decoder output finite {finite}, {len(u_ms)} UNet evals "
                    f"(want {want}), {len(d_ms)} decodes")
            if u_k5 <= 0 or d_k5 <= 0:
                raise AssertionError(f"txt2img {sampler}: K5 launched "
                                     f"{u_k5} times in the UNet and {d_k5} "
                                     "in the decoder")
            log(f"[txt2img] {sampler} image uint8 in [{img.min()}, "
                f"{img.max()}], mean {img.mean():.2f}; decoder output in "
                f"[{float(rec['image'].min()):.3g}, "
                f"{float(rec['image'].max()):.3g}]")
    finally:
        for h in hooks:
            h.remove()

    z = rec["captured"]
    # q, k and v of the mid block's attention (outputs of to_q, to_k, to_v)
    # and its attention output (the input of to_out_0) in the flash decode
    attn, seen = vae.decoder.mid_block_attentions_0, {}

    def keep(tag):
        def hook(module, args, out=None):
            seen[tag] = (args[0] if out is None else out).detach().clone()
        return hook

    hooks = [getattr(attn, f"to_{t}").register_forward_hook(keep(t))
             for t in "qkv"]
    hooks.append(attn.to_out_0.register_forward_pre_hook(keep("out")))
    use_flash = layers.use_flash
    with torch.inference_mode():
        try:
            flash = vae.decoder(z).float()
        finally:
            for h in hooks:
                h.remove()
        q, k, v = (seen[t][:, :, None, :] for t in "qkv")
        scale = 1.0 / math.sqrt(q.shape[-1])
        ref = fa.attention_plain(q.float(), k.float(), v.float(), scale)
        layers.use_flash = lambda *a: False
        try:
            plain = vae.decoder(z).float()
            a_plain = layers.attention_core(q, k, v, scale, q.dtype)
        finally:
            layers.use_flash = use_flash
    err = float((flash - plain).abs().max())
    tol = DECODE_RTOL * float(plain.abs().max())
    log(f"[txt2img] last decode, flash route against the plain attention "
        f"path on the card: max_abs_err {err:.4g} (tol {tol:.4g} = "
        f"{DECODE_RTOL} of max |plain| {float(plain.abs().max()):.4g}); "
        f"mean abs err {float((flash - plain).abs().mean()):.4g}")
    ref = ref[:, :, 0, :]
    e_flash = float((seen["out"].float() - ref).abs().max())
    e_plain = float((a_plain[:, :, 0, :].float() - ref).abs().max())
    a_tol = MID_ATTN_CONTROL_X * e_plain
    log(f"[txt2img] the decoder's mid-block attention output "
        f"{tuple(ref.shape)} in that decode, against f32 scores and softmax "
        f"on its q, k, v: flash max_abs_err {e_flash:.4g}, plain bf16 path "
        f"(control) {e_plain:.4g}; tol {a_tol:.4g} = {MID_ATTN_CONTROL_X}x "
        f"the control; max |ref| {float(ref.abs().max()):.4g}")
    if not err <= tol:
        raise AssertionError("the decoder's flash route disagrees with its "
                             "plain attention path")
    if not e_flash <= a_tol:
        raise AssertionError("the decoder's mid-block attention output "
                             "disagrees with its plain version beyond "
                             f"{MID_ATTN_CONTROL_X}x the bf16 control")
    return total


def export_trainer(guidance=None, steps: int = 8):
    """Without the train phase: a full-width -O trainer (SD random-full)
    trained `steps` steps, for the export phase."""
    from dreamfusion_torch.config import parse_config
    from dreamfusion_torch.training.trainer import Trainer

    ws = tempfile.mkdtemp(prefix="chip_smoke_export_")
    cfg = parse_config(["-O", "--text", "a hamburger", "--sd_weights",
                        "random-full", "--workspace", ws, "--ckpt",
                        "scratch", "--albedo_iters", str(steps // 2)])
    trainer = Trainer("export", cfg, guidance=guidance,
                      use_checkpoint="scratch")
    trainer.train(max_steps=steps, log_interval=steps,
                  checkpoint_at_end=False)
    log(f"[export] trained a new -O trainer {steps} steps (no train phase)")
    return trainer


def phase_export(trainer, frames: int = 2, resolution: int = 256,
                 points: int = 65536):
    """Path (a), `main -O ... --test --save_mesh` on the train phase's
    trainer: test() at `frames` orbit frames, then save_mesh(resolution)
    with the 1024^2 texture, the launch counts set to 0 just before and read
    just after. Prints the threshold, vertex and face counts and each
    stage's seconds, parses the OBJ back, and holds the card's sigma at
    `points` lattice points against the field on the CPU (a copy of the
    params): as trained (bf16 MLPs) to rtol 5e-2 / atol 2e-2, and with both
    copies in f32 to 1e-4 / 1e-5."""

    cfg = trainer.cfg
    torch.cuda.synchronize()
    kcuda.reset_counts()
    t0 = time.perf_counter()
    trainer.test(size=frames, write_video=False)
    torch.cuda.synchronize()
    t_test = time.perf_counter() - t0
    timings, stats = {}, {}
    t1 = time.perf_counter()
    obj = trainer.save_mesh(resolution=resolution, timings=timings,
                            stats=stats)
    t_mesh = time.perf_counter() - t1
    counts = dict(kcuda.launch_counts)
    log(f"[export] test(): {frames} orbit frames at {cfg.H}x{cfg.W} in "
        f"{t_test:.3f} s; save_mesh(resolution={resolution}) {t_mesh:.3f} s: "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in timings.items()))
    log(f"[export] threshold {stats['threshold']:.6g} (mean density "
        f"{float(trainer.grid_state.mean_density):.6g}, density_thresh "
        f"{cfg.density_thresh}); {stats['vertices']:,} vertices, "
        f"{stats['faces']:,} faces; {os.path.getsize(obj) / 2 ** 20:.1f} MiB "
        f"OBJ")
    log(f"[export] kernels {json.dumps(counts)}")
    n_v = n_f = 0
    with open(obj) as f:
        for line in f:
            n_v += line.startswith("v ")
            n_f += line.startswith("f ")
    mdir = os.path.dirname(obj)
    sizes = {n: os.path.getsize(os.path.join(mdir, n))
             for n in ("mesh.obj", "mesh.mtl", "albedo.png")}
    log(f"[export] OBJ parsed back: {n_v:,} v lines, {n_f:,} f lines; "
        f"files {sizes}")
    if (n_v, n_f) != (stats["vertices"], stats["faces"]) or not all(
            sizes.values()):
        raise AssertionError("the exported OBJ does not hold the mesh")
    if min(counts[k] for k in ("composite_compact", "probe_select_small")) <= 0:
        raise AssertionError(f"the orbit before the export launched no "
                             f"eval kernel: {counts}")

    gen = torch.Generator(device="cuda").manual_seed(3)
    idx = torch.randint(0, resolution ** 3, (points,), generator=gen,
                        device="cuda")
    lin = torch.from_numpy(np.linspace(-1, 1, resolution, dtype=np.float32)
                           ).cuda()
    pts = torch.stack([lin[idx // resolution ** 2],
                       lin[(idx // resolution) % resolution],
                       lin[idx % resolution]], -1)

    def f32(model):
        for m in model.modules():
            if hasattr(m, "dtype") and isinstance(m.dtype, torch.dtype):
                m.dtype = torch.float32
        return model

    def sigma(model, dev):
        with torch.no_grad():
            return model.density(pts.to(dev))["sigma"].float().cpu()

    m_cpu = copy.deepcopy(trainer.model).cpu()
    ref, got = sigma(m_cpu, "cpu"), sigma(trainer.model, "cuda")
    g32 = sigma(f32(copy.deepcopy(trainer.model)), "cuda")
    c32 = sigma(f32(m_cpu), "cpu")
    for label, a, b, rtol, atol in (("as trained (bf16 MLPs)", got, ref,
                                     5e-2, 2e-2),
                                    ("both in f32", g32, c32, 1e-4, 1e-5)):
        gap = (a - b).abs()
        bad = int((gap > atol + rtol * b.abs()).sum())
        log(f"[export] sigma at {points:,} lattice points, card against the "
            f"CPU, {label}: max_abs_err {float(gap.max()):.4g} (max |sigma| "
            f"{float(b.abs().max()):.4g}), outside rtol {rtol} / atol "
            f"{atol}: {bad}")
        if bad:
            raise AssertionError(f"the export's density query disagrees "
                                 f"with the CPU ({label})")
    return counts


def phase_gui(guidance=None, bursts: int = 3):
    """Path (c): NeRFGUICore (no display) over a new full-width -O trainer
    (SD random-full: `guidance`), max_spp 2: `bursts` train bursts, preview frames (albedo, then
    lambertian with the light moved, then a still frame that accumulates a
    second sample), the reset, one more burst and a last preview; the
    launch counts set to 0 just before and read just after. Prints each
    burst's size and ms, each preview's resolution, ms and spp."""
    from dreamfusion_torch.apps.gui import NeRFGUICore
    from dreamfusion_torch.config import parse_config
    from dreamfusion_torch.training.trainer import Trainer

    ws = tempfile.mkdtemp(prefix="chip_smoke_gui_")
    argv = ["-O", "--text", "a hamburger", "--sd_weights", "random-full",
            "--workspace", ws, "--ckpt", "scratch", "--max_spp", "2",
            "--albedo_iters", "8"]
    cfg = parse_config(argv)
    trainer = Trainer("gui", cfg, guidance=guidance,
                      use_checkpoint="scratch")
    core = NeRFGUICore(cfg, trainer)
    log(f"[gui] python -m dreamfusion_torch.main {' '.join(argv)} --gui "
        "(headless core)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kcuda.reset_counts()
    losses = []

    def burst(tag):
        n = core.train_steps
        st = core.train_step()
        losses.append(st["loss"])
        log(f"[gui] burst {tag}: {n} steps in {st['time_ms']:.1f} ms "
            f"({st['time_ms'] / n:.1f} ms a step), loss {st['loss']:.5g}; "
            f"next burst {st['train_steps']} steps; trainer step "
            f"{trainer.step}")

    def preview(tag):
        st = core.test_step()
        log(f"[gui] preview {tag} ({core.shading}): {st['resolution'][0]}x"
            f"{st['resolution'][1]} in {st['time_ms']:.1f} ms, spp "
            f"{st['spp']}; next downscale {core.downscale:.4f}")
        if not np.isfinite(core.render_buffer).all():
            raise AssertionError("a GUI preview is not finite")
        return st

    for i in range(bursts):
        burst(i + 1)
        preview(f"after burst {i + 1}")
    core.shading = "lambertian"
    for phi in (45.0, 90.0):
        core.light_dir[1] = phi
        core.need_update = True
        preview(f"light phi {phi}")
    st = preview("still view")
    if st["spp"] != 2:
        raise AssertionError(f"the still view did not accumulate: {st}")
    skipped = core.test_step()
    core.reset()
    log(f"[gui] reset_weights: trainer step {trainer.step}, optimizer "
        f"state {len(trainer.opt.state)} tensors, occupied cells "
        f"{int(trainer.grid_state.occ.sum())}")
    if trainer.step or len(trainer.opt.state) or bool(
            trainer.grid_state.occ.any()):
        raise AssertionError("reset_weights left state behind")
    burst("after reset")
    core.shading = "albedo"
    preview("after reset")
    torch.cuda.synchronize()
    counts = dict(kcuda.launch_counts)
    log(f"[gui] a still view at max_spp skips: {skipped}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    log(f"[gui] kernels {json.dumps(counts)}")
    if not skipped.get("skipped") or not all(np.isfinite(losses)):
        raise AssertionError("the GUI core misbehaved")
    need = TRAIN_KERNELS + ("composite_compact", "probe_select_small")
    if min(counts[k] for k in need) <= 0:
        raise AssertionError(f"a kernel of the GUI path never launched: "
                             f"{counts}")
    return counts


# -- slice 11: DVGO pretraining and a local SD directory ----------------------------

BALL_RADIUS = 1.0
BLENDER_ANGLE_X = 0.6911112070083618      # nerf_synthetic's camera_angle_x


def _ball_colour(o: np.ndarray, d: np.ndarray):
    """(rgb [N, 3], hit [N]) of rays from o along unit d [N, 3] against the
    ball of radius BALL_RADIUS at the origin: 0.5 + 0.5 n by the unit normal
    where they hit it."""
    b = (o * d).sum(-1)
    disc = b * b - ((o * o).sum(-1) - BALL_RADIUS ** 2)
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    return 0.5 + 0.5 * ((o + t[:, None] * d) / BALL_RADIUS), disc > 0


def _ball_view(H: int, W: int, focal: float, c2w: np.ndarray) -> np.ndarray:
    """The analytic ball scene seen from c2w: RGBA uint8 [H, W, 4], the
    ball coloured by _ball_colour, transparent elsewhere."""
    from dreamfusion_torch.datasets.rays import get_rays_of_a_view

    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    ro, _, vd = get_rays_of_a_view(H, W, K, c2w)
    rgb, hit = _ball_colour(ro.reshape(-1, 3).astype(np.float64),
                            vd.reshape(-1, 3))
    rgba = np.zeros((H * W, 4))
    rgba[hit, :3] = rgb[hit]
    rgba[hit, 3] = 1.0
    return np.round(rgba * 255).astype(np.uint8).reshape(H, W, 4)


def _ball_poses(n: int, rng: np.random.RandomState) -> np.ndarray:
    """n cameras [n, 4, 4] on the upper hemisphere at radius 4 looking at
    the origin, placed by rng."""
    from dreamfusion_torch.datasets.loaders import _pose_spherical

    return np.stack([_pose_spherical(rng.uniform(-180, 180),
                                     rng.uniform(-80, -5), 4.0)
                     for _ in range(n)])


def write_ball_scene(root: str, n_train: int = 100, n_val: int = 4,
                     n_test: int = 4, size: int = 400) -> None:
    """The ball scene in the Blender layout (transforms_{split}.json and
    RGBA PNGs by the port's write_png), nerf_synthetic at half resolution:
    cameras on the upper hemisphere at radius 4 looking at the origin."""
    from dreamfusion_torch.training.trainer import write_png

    focal = 0.5 * size / math.tan(0.5 * BLENDER_ANGLE_X)
    rng = np.random.RandomState(0)
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i, c2w in enumerate(_ball_poses(n, rng)):
            write_png(os.path.join(root, split, f"r_{i}.png"),
                      _ball_view(size, size, focal, c2w))
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": BLENDER_ANGLE_X, "frames": frames}, f)


def _pooled_psnr(trainer, loader) -> float:
    """PSNR of the mean squared error over all of a loader's rays (the
    pipeline's test PSNR is the mean of per-batch PSNRs, which batches of
    background alone, at the 1e-10 floor, lift toward 100 dB)."""
    se, n = 0.0, 0
    with torch.no_grad():
        for batch in loader:
            rays_d, rays_o, viewdirs, target = trainer._batch(batch)
            pred = trainer.field.render(
                rays_o, rays_d, viewdirs, near=trainer.near, far=trainer.far,
                bg=trainer.bg, n_samples=trainer.n_samples)["rgb_marched"]
            se += float(((pred - target) ** 2).sum())
            n += target.numel()
    return -10.0 * math.log10(max(se / n, 1e-10))


def phase_pretrain(guidance=None, coarse_iters: int = 300,
                   fine_iters: int = 300, log_every: int = 25):
    """DVGO pretraining at the published DVGO Blender widths (the port's
    nerf_pipeline.DEFAULTS: coarse 1,024,000 voxels, k0 3; fine 160^3, k0
    12, a 128 x 3 ResMLP, PE 5 / 4; stepsize 0.5; 8,192 rays a step) on
    the ball scene written in the Blender layout and read back by
    load_data, cut in depth: `coarse_iters` coarse iterations from 512,000
    voxels with one pg_scale milestone to 1,024,000 (DVGO starts at
    num_voxels / 2^len(pg_scale)), `fine_iters` fine. Then the .dvgo into
    DVGOEditNetwork (sigma and albedo at 65,536 points equal the fine
    field's, f32 atol 1e-6), 3 editing steps through the Trainer (SD
    random-full: `guidance`) and one 800x800 ImageRenderer frame. The
    fine stage is cut to 300 iterations, not the ~500 first planned: its
    plain-PyTorch step takes ~0.48 s on the card, 92% of it in the index
    backward of grid_sample_3d's gather (PERF.md, PR 11). Returns
    (pretraining launch counts, editing launch counts)."""
    import shutil

    from dreamfusion_torch.config import parse_config
    from dreamfusion_torch.datasets import load_data
    from dreamfusion_torch.models.kailu import DVGOEditNetwork
    from dreamfusion_torch.training.dvgo_trainer import DVGOTrainer
    from dreamfusion_torch.training.image_renderer import (ImageRenderer,
                                                           load_dvgo_field)
    from dreamfusion_torch.training.nerf_pipeline import (_loader,
                                                          train_nerf_models)
    from dreamfusion_torch.training.trainer import Trainer

    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pretrain_")
    try:
        scene = os.path.join(tmp, "ball")
        t0 = time.perf_counter()
        write_ball_scene(scene)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        data = load_data({"dataset_type": "blender", "datadir": scene})
        t_read = time.perf_counter() - t0
        log(f"[pretrain] ball scene (radius {BALL_RADIUS}, normal-coloured) "
            f"in the Blender layout: {len(data['i_train'])} train, "
            f"{len(data['i_val'])} val, {len(data['i_test'])} test views of "
            f"{data['HW'][0][0]}x{data['HW'][0][1]}, near {data['near']} far "
            f"{data['far']}; written in {t_write:.1f} s, load_data "
            f"(read_png) {t_read:.1f} s")

        stamps = {"coarse": [], "fine": []}

        def log_fn(msg):
            for stage in stamps:
                if msg.startswith(f"[{stage} "):
                    it = int(msg.split()[1].rstrip("]"))
                    stamps[stage].append((it, time.perf_counter()))
                    if it % 100 and it != (coarse_iters if stage == "coarse"
                                           else fine_iters) - 1:
                        return
            log(f"[pretrain] {msg[:240]}")

        params = {"cfg_data": None, "data_dict": data, "batch_size": 8192,
                  "coarse_model": {"num_voxels": 512000},
                  "coarse_train": {"n_iters": coarse_iters,
                                   "pg_scale": (coarse_iters // 2,)},
                  "fine_train": {"n_iters": fine_iters},
                  "save_name": os.path.join(tmp, "ball.dvgo"),
                  "log_every": log_every}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kcuda.reset_counts()
        t0 = time.perf_counter()
        out = train_nerf_models(params, log_fn=log_fn, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kcuda.launch_counts)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tr_c, tr_f = out["coarse_trainer"], out["fine_trainer"]
        rates = {}
        for stage, st in stamps.items():
            (i0, t_0), (i1, t_1) = st[1], st[-1]
            rates[stage] = (i1 - i0) / (t_1 - t_0)
        log(f"[pretrain] coarse world_size {tr_c.field.world_size} "
            f"({math.prod(tr_c.field.world_size):,} voxels after the "
            f"milestone at {coarse_iters // 2}), {tr_c.n_samples} samples a "
            f"ray; fine world_size {tr_f.field.world_size} "
            f"({math.prod(tr_f.field.world_size):,} voxels), box "
            f"{tuple(round(v, 4) for v in tr_f.field.xyz_min)} ~ "
            f"{tuple(round(v, 4) for v in tr_f.field.xyz_max)}, "
            f"{tr_f.n_samples} samples a ray")
        log(f"[pretrain] steps/s after warm-up (iterations {log_every}..end, "
            f"synced at each log line every {log_every}): coarse "
            f"{rates['coarse']:.4f}, fine {rates['fine']:.4f}; the whole "
            f"pipeline {wall:.1f} s; peak device memory {peak:.2f} GiB")
        log(f"[pretrain] kernels of the pretraining run {json.dumps(counts)}")
        if not only_grid_sample(counts):
            raise AssertionError("DVGO pretraining must launch kernel G in "
                                 f"both ways and no other kernel: {counts}")

        # the fine field before training: a trainer from the same seed and
        # shape initialises it as the pipeline's did
        test_dl = _loader(data, {}, "i_test", "random", 8192, cap=819200)
        fresh = DVGOTrainer(type(tr_f.field)(
            world_size=tr_f.field.world_size, k0_dim=12,
            rgbnet_name="resmlp", xyz_min=tr_f.field.xyz_min,
            xyz_max=tr_f.field.xyz_max, alpha_init=1e-2),
            tr_f.stage, near=data["near"], far=data["far"], device=dev)
        psnr0 = fresh.evaluate(test_dl)
        psnr1 = out["test_psnr"]
        pooled0, pooled1 = _pooled_psnr(fresh, test_dl), _pooled_psnr(
            tr_f, test_dl)
        log(f"[pretrain] test PSNR over {len(test_dl.dataset):,} rays (the "
            f"pipeline's mean of {len(test_dl)} batch PSNRs): untrained fine "
            f"field {psnr0:.3f} dB, trained {psnr1:.3f} dB (+"
            f"{psnr1 - psnr0:.3f}); of the pooled squared error: "
            f"{pooled0:.3f} -> {pooled1:.3f} dB (+{pooled1 - pooled0:.3f})")
        if not (psnr1 >= psnr0 + 5.0 and pooled1 >= pooled0 + 5.0):
            raise AssertionError("the trained fine field is not 5 dB above "
                                 "the untrained one")
        del fresh

        # a fine step under the profiler: where its device time goes
        batch = next(iter(_loader(data, {}, "i_train", "random", 8192)))
        _profiled(lambda: tr_f.step(batch), 2, "fine step", ("dvgo/",))

        # the .dvgo round trip
        path = os.path.join(tmp, "again.dvgo")
        t0 = time.perf_counter()
        tr_f.save_dvgo(path)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        field = load_dvgo_field(path, dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        cfg = parse_config(["-O", "--backbone", "dvgo", "--pretrained_dvgo",
                            path, "--bg_radius", "0", "--text",
                            "a golden ball", "--sd_weights", "random-full",
                            "--iters", "3", "--albedo_iters", "1",
                            "--workspace", os.path.join(tmp, "ws"),
                            "--ckpt", "scratch", "--seed", "0"])
        edit = DVGOEditNetwork.from_config(cfg)
        edit.load_pretrained()
        edit = edit.to(dev)
        ref = copy.deepcopy(edit)
        ref.main.load_state_dict(tr_f.field.state_dict())
        x = torch.rand(65536, 3, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(5)
                       ) * 2 - 1
        with torch.no_grad():
            (s_a, a_a), (s_b, a_b) = edit.common(x), ref.common(x)
        gap = max(float((s_a - s_b).abs().max()), float((a_a - a_b).abs().max()))
        gap_f = max(float((getattr(field, k) - getattr(tr_f.field, k))
                          .detach().abs().max()) for k in ("density", "k0"))
        log(f"[pretrain] .dvgo ({os.path.getsize(path) / 2 ** 20:.0f} MiB) "
            f"write {t_save * 1e3:.1f} ms, read into a field on the card "
            f"{t_load * 1e3:.1f} ms; DVGOEditNetwork sigma and albedo at "
            f"65,536 points vs the fine field: max abs {gap:.3e}, grids "
            f"{gap_f:.3e}; {int((s_a > 1).sum())} points with sigma > 1")
        if not (gap <= 1e-6 and gap_f <= 1e-6):
            raise AssertionError("the .dvgo round trip changed the field")
        del edit, ref

        trainer = Trainer("pretrain_edit", cfg, guidance=guidance,
                          use_checkpoint="scratch")
        rate, ecounts, losses, _, epeak = _train_timed(trainer, 3, 1)
        log(f"[pretrain] 3 editing steps of the trained scene (python -m "
            f"dreamfusion_torch.main -O --backbone dvgo --pretrained_dvgo "
            f"<it> --bg_radius 0 --sd_weights random-full): losses "
            + " ".join(f"{float(v):.4g}" for v in losses)
            + f"; {rate:.4f} steps/s after 1; peak {epeak:.2f} GiB; kernels "
            f"{json.dumps(ecounts)}")
        if not bool(torch.isfinite(losses).all()) or min(
                ecounts[k] for k in EDIT_TRAIN_KERNELS) <= 0:
            raise AssertionError(f"editing the trained scene: {ecounts}")
        del trainer

        # one 800x800 frame of the fine field through ImageRenderer, against
        # the analytic scene at that size
        size = 800
        focal = 0.5 * size / math.tan(0.5 * BLENDER_ANGLE_X)
        K = np.array([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1]],
                     np.float32)
        pose = data["poses"][data["i_test"][0]]
        r = ImageRenderer(tr_f.field, near=data["near"], far=data["far"],
                          batch_size=8192)
        f64 = focal * 64 / size
        r.renderView(64, 64, np.array([[f64, 0, 32], [0, f64, 32], [0, 0, 1]],
                                      np.float32), pose)       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = r.renderView(size, size, K, pose)
        t_frame = time.perf_counter() - t0
        gt = _ball_view(size, size, focal, pose).astype(np.float64) / 255
        gt = gt[..., :3] * gt[..., 3:] + (1 - gt[..., 3:])
        frame_psnr = -10 * math.log10(float(((img - gt) ** 2).mean()))
        log(f"[pretrain] ImageRenderer {size}x{size} frame of test view 0: "
            f"{t_frame * 1e3:.1f} ms ({size * size // 8192 + 1} chunks of "
            f"8,192 rays), PSNR {frame_psnr:.3f} dB against the analytic "
            f"scene")
        if img.shape != (size, size, 3) or not np.isfinite(img).all():
            raise AssertionError("the 800x800 frame is not finite")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts, ecounts


def synthetic_bpe(corpus: str, n_merges: int = 300, drop=(),
                  specials_first: bool = False):
    """A small CLIP vocabulary: the 512 byte symbols (with and without
    </w>), the first `n_merges` merges a greedy BPE learns on `corpus`, and
    the two special tokens (last, or at ids 3 and 4); the `drop` symbols
    are left out, so that they map to the unknown token. Returns (vocab
    dict, merges.txt lines). The CPU tests build their vocabularies here
    too."""
    from collections import Counter

    from dreamfusion_torch.guidance.tokenizer import bytes_to_unicode

    be = bytes_to_unicode()
    symbols = list(be.values()) + [c + "</w>" for c in be.values()]
    words = Counter()
    for w in corpus.lower().split():
        sym = "".join(be[b] for b in w.encode())
        words[tuple(sym[:-1]) + (sym[-1] + "</w>",)] += 1
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for w, c in words.items():
            for a, b in zip(w[:-1], w[1:]):
                pairs[(a, b)] += c
        if not pairs:
            break
        best = max(sorted(pairs), key=lambda p: pairs[p])
        merges.append(best)
        merged = Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
        symbols.append(best[0] + best[1])
    symbols = [s for s in dict.fromkeys(symbols) if s not in drop]
    specials = ["<|startoftext|>", "<|endoftext|>"]
    symbols = (symbols[:3] + specials + symbols[3:] if specials_first
               else symbols + specials)
    return ({s: i for i, s in enumerate(symbols)},
            ["#version: 0.2"] + [f"{a} {b}" for a, b in merges])


# SD v1.5's text encoder (CLIP ViT-L/14's text tower, text_encoder/config.json)
SD15_TEXT = dict(vocab_size=49408, hidden_size=768, intermediate_size=3072,
                 num_hidden_layers=12, num_attention_heads=12,
                 max_position_embeddings=77, hidden_act="quick_gelu",
                 layer_norm_eps=1e-5, bos_token_id=0, eos_token_id=2,
                 pad_token_id=1, projection_dim=768,
                 architectures=["CLIPTextModel"], model_type="clip_text_model",
                 torch_dtype="float16")
SD_PROMPTS = ["a DSLR photo of a corgi wearing a beret", "a hamburger"]


def write_sd_dir(root: str, seed: int = 1):
    """A diffusers-layout SD directory at SD v1.5 widths from a seed: the
    random-full UNet and VAE (flax's init on the card, bf16 as the trainer
    holds them, rounded through float16) under diffusers names in float16
    safetensors, as the published fp16 variant stores them; a random text
    encoder at ViT-L/14's text widths (float16, config.json); a synthetic
    BPE tokenizer. Returns (the source guidance, {module: the written
    float16 arrays by port key})."""
    from dreamfusion_torch.guidance.clip import CLIPTextTransformer
    from dreamfusion_torch.guidance.sd.convert import (diffusers_names,
                                                       write_safetensors)
    from dreamfusion_torch.guidance.sd.sds import build_sd_guidance

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    src = build_sd_guidance("random-full", dtype=torch.bfloat16, device=dev,
                            generator=gen)
    written = {}
    for name in ("unet", "vae"):
        m = src.modules[name]
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(p.half().to(p.dtype))
        sd = {k: v.detach().half().cpu().numpy()
              for k, v in m.state_dict().items()}
        written[name] = sd
        os.makedirs(os.path.join(root, name))
        write_safetensors(os.path.join(root, name,
                                       "diffusion_pytorch_model.safetensors"),
                          diffusers_names(sd))
    text = CLIPTextTransformer(SD15_TEXT)
    tg = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, p in text.named_parameters():
            if "norm" in k:
                p.copy_(1.0 + 0.02 * torch.randn(p.shape, generator=tg)
                        if k.endswith("weight") else
                        0.02 * torch.randn(p.shape, generator=tg))
            else:
                p.normal_(0.0, 0.02, generator=tg)
    te = {("text_model." + k).replace("_embedding.embedding",
                                      "_embedding.weight"):
          v.half().numpy() for k, v in text.state_dict().items()}
    written["text_encoder"] = te
    os.makedirs(os.path.join(root, "text_encoder"))
    write_safetensors(os.path.join(root, "text_encoder", "model.safetensors"),
                      te)
    with open(os.path.join(root, "text_encoder", "config.json"), "w") as f:
        json.dump(SD15_TEXT, f)
    vocab, merges = synthetic_bpe(" ".join(SD_PROMPTS * 3)
                                   + " a photo of the red cube, 42 times")
    os.makedirs(os.path.join(root, "tokenizer"))
    with open(os.path.join(root, "tokenizer", "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(root, "tokenizer", "merges.txt"), "w") as f:
        f.write("\n".join(merges) + "\n")
    return src, written


def phase_sd_dir(steps: int = 5):
    """A whole SD directory at SD v1.5 widths through the probe: written
    in a temporary directory (write_sd_dir), found by build_guidance with
    sd_weights None through $SD_WEIGHTS_DIR (set for this phase only),
    loaded; every loaded tensor equal to what was written after the
    compute dtype's cast, the ids and text embeddings of two prompts equal
    to the port's CPU path (f32, rtol 1e-5), one UNet eps equal to the
    source module's on a fixed input; then `steps` SDS steps of -O on it.
    Returns the SDS steps' launch counts."""
    import shutil

    from dreamfusion_torch.config import parse_config
    from dreamfusion_torch.guidance import build_guidance
    from dreamfusion_torch.guidance.clip import CLIPTextTransformer
    from dreamfusion_torch.guidance.sd.convert import load_module_dir
    from dreamfusion_torch.guidance.sd.probe import find_sd_weights
    from dreamfusion_torch.guidance.tokenizer import CLIPBPETokenizer
    from dreamfusion_torch.training.trainer import Trainer
    from dreamfusion_torch.weights import load_hf_clip

    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sd_dir_")
    root = os.path.join(tmp, "stable-diffusion-v1-5")
    old_env = os.environ.get("SD_WEIGHTS_DIR")
    try:
        t0 = time.perf_counter()
        src, written = write_sd_dir(root)
        t_write = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(root) for f in fs)
        log(f"[sd_dir] wrote {root}: unet/, vae/ (float16 safetensors, "
            f"diffusers names), text_encoder/ (12 x 768, float16), "
            f"tokenizer/ ({len(json.load(open(os.path.join(root, 'tokenizer', 'vocab.json')))):,} "
            f"tokens); {size / 2 ** 30:.3f} GiB in {t_write:.1f} s")
        os.environ["SD_WEIGHTS_DIR"] = root
        cfg = parse_config(["-O", "--text", "a DSLR photo of a corgi",
                            "--iters", str(steps), "--albedo_iters",
                            str(steps // 2), "--workspace",
                            os.path.join(tmp, "ws"), "--ckpt", "scratch",
                            "--seed", "0"])
        assert cfg.sd_weights is None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = build_guidance(cfg, dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        picked = find_sd_weights(verbose=False)
        log(f"[sd_dir] build_guidance(sd_weights=None): the probe picked "
            f"{picked}; loaded in {t_load:.1f} s")
        if picked != root or g.modules.get("text_encode") is None:
            raise AssertionError("the probe did not pick the SD directory")

        # every tensor as written, after the compute dtype's cast
        worst = 0
        for name in ("unet", "vae"):
            for k, v in g.modules[name].state_dict().items():
                want = torch.from_numpy(written[name][k]).to(dev, v.dtype)
                if not torch.equal(v, want):
                    raise AssertionError(f"{name}.{k} differs from the file")
                worst += 1
        text_model = g.modules["text_encode"].text_model
        for k, v in text_model.state_dict().items():
            hf = ("text_model." + k).replace("_embedding.embedding",
                                              "_embedding.weight")
            want = torch.from_numpy(written["text_encoder"][hf]).to(dev,
                                                                   v.dtype)
            if not torch.equal(v, want):
                raise AssertionError(f"text_encoder {k} differs from the file")
            worst += 1
        log(f"[sd_dir] {worst} loaded tensors equal the written float16 "
            f"values cast to their compute dtype (UNet and VAE "
            f"{next(g.modules['unet'].parameters()).dtype}, norms float32, "
            f"text encoder float32)")

        # ids and embeddings against the CPU path
        tok = CLIPBPETokenizer.from_dir(os.path.join(root, "tokenizer"))
        cpu_text = CLIPTextTransformer(json.load(open(os.path.join(
            root, "text_encoder", "config.json"))))
        load_hf_clip(cpu_text, load_module_dir(os.path.join(root,
                                                            "text_encoder")),
                     prefix="text_model.")
        ids = tok(SD_PROMPTS)
        with torch.no_grad():
            ref = cpu_text.last_hidden_state(torch.from_numpy(ids))
        g.modules["text_encode"](SD_PROMPTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb = g.modules["text_encode"](SD_PROMPTS)
        torch.cuda.synchronize()
        t_text = (time.perf_counter() - t0) * 1e3
        ids_gpu = g.modules["text_encode"].tokenizer(SD_PROMPTS)
        rel = rel_err(emb.float().cpu(), ref)
        log(f"[sd_dir] ids of {len(SD_PROMPTS)} prompts equal the CPU "
            f"tokenizer's: {bool(np.array_equal(ids_gpu, ids))} (first "
            f"{ids[0][:10].tolist()}); text embeddings {tuple(emb.shape)} vs "
            f"the CPU path: rel {rel:.3e}; text encode {t_text:.2f} ms for "
            f"{len(SD_PROMPTS)} prompts")
        if not np.array_equal(ids_gpu, ids) or not rel <= 1e-5:
            raise AssertionError("text ids or embeddings differ from the CPU")

        # one UNet eps against the source module
        gen = torch.Generator(device=dev).manual_seed(3)
        lat = torch.randn(2, 64, 64, 4, device=dev, generator=gen)
        t = torch.tensor([100, 700], device=dev)
        ctx = emb.float()
        with torch.no_grad():
            e_src = src.modules["unet"](lat, t, ctx)
            e_dir = g.modules["unet"](lat, t, ctx)
        eps_rel = rel_err(e_dir.float(), e_src.float())
        log(f"[sd_dir] UNet eps on a fixed input (B=2, 64x64 latents, the "
            f"prompts' embeddings): loaded vs source module rel {eps_rel:.3e}"
            f", bitwise equal {bool(torch.equal(e_src, e_dir))}")
        if not eps_rel <= 1e-3:
            raise AssertionError("the loaded UNet differs from its source")
        del src

        trainer = Trainer("sd_dir", cfg, guidance=g, use_checkpoint="scratch")
        rate, counts, losses, _, peak = _train_timed(trainer, steps, 1)
        log(f"[sd_dir] {steps} SDS steps of -O on the loaded directory: "
            f"losses " + " ".join(f"{float(v):.4g}" for v in losses)
            + f"; {rate:.4f} steps/s after 1; peak {peak:.2f} GiB; kernels "
            f"{json.dumps(counts)}")
        if not bool(torch.isfinite(losses).all()) or min(
                counts[k] for k in TRAIN_KERNELS) <= 0:
            raise AssertionError(f"SDS on the loaded directory: {counts}")
    finally:
        if old_env is None:
            os.environ.pop("SD_WEIGHTS_DIR", None)
        else:
            os.environ["SD_WEIGHTS_DIR"] = old_env
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[sd_dir] directory deleted: {not os.path.exists(root)}")
    return counts


# -- slice 12: the DVGO model zoo, the OSR fields and the job layer ---------------

# each class of the registry beyond the base, with the decoder the JAX
# package's tests give it (tests/test_zoo.py:24-34, tests/test_osr.py:39-47)
ZOO_FIELDS = (("dvp_fine", "basicmlp"), ("nwnn_fine", None),
              ("ffl_fine", "basicmlp"), ("fastffl_fine", "basicmlp"),
              ("dvgo360_fine", "basicmlp"), ("osr_fine", "shadowmlp"),
              ("osr_v2_fine", "shadowmlp"), ("osr_v3_fine", "basicmlp"),
              ("osr_v4_fine", "separateshadowmlp"),
              ("osr_v5_fine", "basicmlp"), ("osr_v6_fine", "basicmlp"),
              ("osr_rgi_fine", "basicmlp"))
ZOO_BOX = 1.1                   # the field's box: the ball of radius 1 and a margin
ZOO_WORLD, ZOO_RAYS = 160, 8192     # DVGO fine width; rays a step
# the OSR fields whose normal (a second-order term in training) steers
# their colour: held to 3x a CPU control whose ray origins move by an ulp
NORMAL_FIELDS = ("osr_fine", "osr_v2_fine")


def ball_density(world: int, box: float, seed: int, radius: float = 1.0,
                 slope: float = 100.0, noise: float = 0.5) -> torch.Tensor:
    """[1, W, W, W] density of the ball scene's ball in a +-box grid, as
    write_dvgo seeds its scene: clamp((radius - r) * slope, -20, 30) plus
    noise of std `noise`; the floor of -20 keeps the empty samples' weight
    (alpha ~1e-11 after DVGO's act_shift) under fast_color_thres."""
    g = torch.Generator().manual_seed(seed)
    lin = torch.linspace(-box, box, world)
    X, Y, Z = torch.meshgrid(lin, lin, lin, indexing="ij")
    r = torch.sqrt(X * X + Y * Y + Z * Z)
    d = torch.clamp((radius - r) * slope, -20.0, 30.0) \
        + noise * torch.randn(world, world, world, generator=g)
    return d[None]


def _zoo_card_vs_cpu(name, field, batch, near, far, gen):
    """64 rays of the field rendered on the card and by its CPU copy with
    the same draws (under no_grad, the OSR normals in their local
    enable_grad): every output to rtol 1e-4 / atol 1e-5, or, for the fields
    whose normal steers, within 3x a CPU control whose ray origins move by
    one ulp either way (the per-sample outputs a live mask fills, where
    both devices' masks agree; OSR's marched normal and irradiance on the
    rays where the samples whose mask differs weigh <= 1e-5 of the ray);
    for those fields the normal (alpha's
    position gradient) also at the CPU's live sample positions on both
    devices, rtol 1e-4 / atol 1e-5 of its largest entry. FastFFL's rays with a sample whose u lies within 1e-6 of
    a cdf entry are counted and left out (the two may pick another
    corner).
    Returns (worst gap / its bound, the rays compared)."""
    from dreamfusion_torch.models.dvgo import sample_ray

    n = 64
    rays_d, rays_o, viewdirs = (b[:n].cpu() for b in batch[:3])
    S = field.n_render_samples(far)
    draws = {k: (torch.rand if kind == "uniform" else torch.randn)(
        *shape, generator=gen) for k, (shape, kind) in
        field.draw_spec(n, S).items()}
    cpu_field = copy.deepcopy(field).cpu()
    kw = dict(near=near, far=far, bg=torch.ones(3), n_samples=S)
    with torch.no_grad():
        got = field.render(rays_o.cuda(), rays_d.cuda(), viewdirs.cuda(),
                           **dict(kw, bg=kw["bg"].cuda()),
                           **{k: v.cuda() for k, v in draws.items()})
        ref = cpu_field.render(rays_o, rays_d, viewdirs, **kw, **draws)
        ctl = None
        if name in NORMAL_FIELDS:
            # the trilinear position gradient jumps where a sample crosses a
            # cell face, and the card rounds the sample positions otherwise
            # (FMA): the control moves the ray origins one ulp either way
            # (a jitter moved by 2^-24 moves no sample past the first:
            # arange(S) + jitter absorbs it)
            ctl = [cpu_field.render(torch.nextafter(rays_o, torch.full_like(
                rays_o, sign * math.inf)), rays_d, viewdirs, **kw, **draws)
                for sign in (1, -1)]
        keep = torch.ones(n, dtype=torch.bool)
        if "choice_u" in draws:
            pts, oob = sample_ray(
                rays_o, rays_d, near=near, far=far, xyz_min=cpu_field.mins,
                xyz_max=cpu_field.maxs, voxel_size=cpu_field.voxel_size,
                stepsize=cpu_field.stepsize, n_samples=S,
                jitter=draws["jitter"])
            alpha = torch.where(oob, 0.0, cpu_field.query_alpha(pts))
            live = alpha > cpu_field.alpha_thres
            _, w = cpu_field._liif_features(pts[live],
                                            viewdirs[:, None].expand(
                                                pts.shape)[live])
            tie = torch.zeros_like(live)
            tie[live] = ((torch.cumsum(w, -1) + 1e-3
                          - draws["choice_u"][live]).abs() < 1e-6).any(-1)
            keep = ~tie.any(-1)
            log(f"[zoo] {name}: {int(tie.sum())} of {int(live.sum())} live "
                f"samples within 1e-6 of a cdf entry; {int(keep.sum())} of "
                f"{n} rays compared")
    # the per-sample outputs that a live mask fills (0.5, 1, 0 where
    # weights <= fast_color_thres): compared where both devices' masks
    # agree. Near the ball's edge alpha = 1 - exp(-x) is quantised to steps
    # of ~6e-8 in f32, so a sample's weight can fall on either side of the
    # 1e-7 threshold on the two devices (its weight moves the marched
    # colour by ~1e-8). OSR's marched normal (and the irradiance read from
    # it) normalises a weighted sum: on a ray that misses the ball every
    # weight is below ~1e-7, and one such sample on the other side of the
    # mask (V2 also masks weights > 0) turns its direction; those two are
    # compared on the rays whose flipped samples carry at most 1e-5 of the
    # ray's weight
    thr = field.fast_color_thres
    wg, wc = got["weights"].cpu()[keep], ref["weights"][keep]
    flip = ((wg > thr) != (wc > thr)) | ((wg > 0) != (wc > 0))
    steady = (torch.where(flip, torch.maximum(wg, wc), 0.0).sum(-1)
              <= 1e-5 * wc.sum(-1))
    ratios = {}
    for k, r in ref.items():
        g, r = got[k].cpu()[keep], r[keep]
        bound = 1e-5 + 1e-4 * r.abs()
        if ctl is not None:
            bound = torch.maximum(bound, 3 * torch.maximum(
                (ctl[0][k][keep] - r).abs(), (ctl[1][k][keep] - r).abs()))
        ratio = (g - r).abs() / bound
        if k in ("raw_rgb", "raw_shadow", "raw_rg"):
            ratio = ratio[~flip]
        elif k in ("normal_marched", "irradiance"):
            ratio = ratio[steady]
        ratios[k] = float(ratio.max()) if ratio.numel() else 0.0
    if name in NORMAL_FIELDS:
        # the normal itself (d alpha / d position, a second derivative of
        # the density in training) at the same positions on both devices:
        # the CPU's live samples
        with torch.no_grad():
            pts, _ = sample_ray(
                rays_o, rays_d, near=near, far=far, xyz_min=cpu_field.mins,
                xyz_max=cpu_field.maxs, voxel_size=cpu_field.voxel_size,
                stepsize=cpu_field.stepsize, n_samples=S,
                jitter=draws["jitter"])
        pts = pts[ref["weights"] > thr]
        g_ref = cpu_field.alpha_gradient(pts)
        g_got = field.alpha_gradient(pts.cuda()).cpu()
        ratios["alpha_gradient"] = float(((g_got - g_ref).abs() / (
            1e-5 * g_ref.abs().max() + 1e-4 * g_ref.abs())).max())
    worst = max(ratios, key=ratios.get)
    log(f"[zoo] {name} card vs CPU: {int(flip.sum())} of {flip.numel()} "
        f"samples on either side of the live mask on the two devices, "
        f"{int((~steady).sum())} rays where they weigh; gap / bound by "
        f"output: " + ", ".join(
            f"{k} {v:.3g}" for k, v in ratios.items()))
    return ratios[worst], int(keep.sum())


def phase_zoo(data, steps: int = 5, warmup: int = 2):
    """Each class of the zoo and the OSR fields (12) at DVGO fine width
    (160^3 grids, k0 12, a 128 x 3 decoder of the kind the JAX tests give
    it, PE 5 / 4, stepsize 0.5; NeRFWoNN k0 12 = SH degree 2), its density
    the ball scene's ball (ball_density), trained `steps` steps by
    DVGOTrainer on the ball scene `data`, 8,192 rays a step: losses finite,
    every parameter moved (env too), steps/s after `warmup`, peak memory,
    one step's device time by kernel; 64 rays against the CPU copy
    (_zoo_card_vs_cpu); one evaluate batch of OSR_Fine under no_grad.
    OSR_Fine_RGI returns no raw_rgb, so it trains with weight_rgbper 0, as
    the JAX package must. Returns the launch counts of the training steps
    (kernel G's alone)."""
    from dreamfusion_torch.models.zoo import get_field
    from dreamfusion_torch.training.dvgo_trainer import (DVGOStageConfig,
                                                         DVGOTrainer)
    from dreamfusion_torch.training.nerf_pipeline import _loader

    dev = torch.device("cuda")
    near, far = data["near"], data["far"]
    def batches():              # the shuffled train rays, epoch after epoch
        loader = _loader(data, {}, "i_train", "random", ZOO_RAYS)
        while True:
            yield from loader

    train = batches()
    # ZOO_RAYS test rays drawn from all the test views' pixels (in order,
    # the first rows of a view miss the ball)
    test_all = next(iter(_loader(data, {}, "i_test", "random", 1 << 30)))
    gen = torch.Generator().manual_seed(12)
    pick = torch.randperm(len(test_all[0]), generator=gen)[:ZOO_RAYS].numpy()
    test_batch = tuple(b[pick] for b in test_all)
    counts, failed = {}, []
    for i, (name, decoder) in enumerate(ZOO_FIELDS):
        t_cls = time.perf_counter()
        field = get_field(name, world_size=(ZOO_WORLD,) * 3, k0_dim=12,
                          rgbnet_name=decoder, rgbnet_width=128,
                          rgbnet_depth=3, posbase_pe=5, viewbase_pe=4,
                          xyz_min=(-ZOO_BOX,) * 3, xyz_max=(ZOO_BOX,) * 3,
                          alpha_init=1e-2, stepsize=0.5)
        stage = DVGOStageConfig(n_iters=steps, batch_size=ZOO_RAYS,
                                weight_rgbper=0.0 if name == "osr_rgi_fine"
                                else 0.1)
        tr = DVGOTrainer(field, stage, near=near, far=far, seed=i, device=dev)
        with torch.no_grad():
            field.density.copy_(ball_density(ZOO_WORLD, ZOO_BOX, seed=i))
        before = {k: p.detach().clone() for k, p in field.named_parameters()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kcuda.reset_counts()
        losses = []
        for it in range(steps):
            if it == warmup:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            losses.append(tr.step(next(train))["loss"])
        torch.cuda.synchronize()
        rate = (steps - warmup) / (time.perf_counter() - t0)
        for k, v in kcuda.launch_counts.items():
            counts[k] = counts.get(k, 0) + v
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = torch.stack(losses).cpu()
        moved = {k: float((p.detach() - before[k]).abs().max())
                 for k, p in field.named_parameters()}
        _profiled(lambda: tr.step(next(train)), 1, f"{name} step", (),
                  top=3)
        worst, n_cmp = _zoo_card_vs_cpu(name, field, tr._batch(test_batch),
                                        near, far, gen)
        log(f"[zoo] {name} ({type(field).__name__}, {decoder}): "
            f"{tr.n_samples} samples a ray; losses "
            + " ".join(f"{float(v):.4g}" for v in losses)
            + f"; {rate:.4f} steps/s after {warmup}; peak {peak:.2f} GiB"
            f"; smallest parameter move {min(moved.values()):.3e}"
            + (f" (env {moved['env']:.3e})" if "env" in moved else "")
            + f"; card vs CPU on {n_cmp} rays: worst gap / bound {worst:.3f}"
            f"; {time.perf_counter() - t_cls:.1f} s")
        if not bool(torch.isfinite(losses).all()):
            failed.append(f"{name}: a loss is not finite")
        if min(moved.values()) <= 0:
            failed.append(f"{name}: parameters did not move: "
                          f"{[k for k, v in moved.items() if v <= 0]}")
        if not worst <= 1.0:
            failed.append(f"{name}: the card's render is off the CPU's "
                          f"({worst:.3f} of its bound)")
        if name == "osr_fine":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            psnr_eval = tr.evaluate([test_batch])
            log(f"[zoo] osr_fine evaluate, one batch of 8,192 test rays "
                f"under no_grad: PSNR {psnr_eval:.3f} dB, "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
            if not math.isfinite(psnr_eval):
                failed.append("osr_fine: evaluate is not finite")
        del tr, field, before
        torch.cuda.empty_cache()
    log(f"[zoo] kernels of the zoo's training steps {json.dumps(counts)}")
    if failed:        # every class runs first, then the phase fails
        raise AssertionError("; ".join(failed))
    if not only_grid_sample(counts):
        raise AssertionError("the zoo's steps must launch kernel G in both "
                             f"ways and no other kernel: {counts}")
    return counts


# the job's depth: 500 coarse iterations (from DVGO's N(0, 1) init at lr
# 0.1, 100 leave no coarse cell above the fine box's alpha threshold and 300
# a box short of the ball, on the CPU at 100x100 views) and 100 fine (the
# mesh of edit_scene needs densities above ~5.1: sigma 10 after the edit
# field's softplus x 10)
JOB_COARSE_ITERS, JOB_FINE_ITERS = 500, 100


def phase_jobs(scene: str):
    """The job layer on the card: LocalBackend.submit of
    dreamfusion_torch.training.jobs:train_model with params_for_nerf(the
    ball scene) as a subprocess (the widths of nerf_pipeline.DEFAULTS; cut
    in depth to JOB_COARSE_ITERS coarse and JOB_FINE_ITERS fine
    iterations), its job directory checked (params.json, metrics.jsonl with
    test/psnr, the weight-hash line, the .dvgo); then the port's
    edit_scene on that .dvgo with --iters 3 and a workspace in a temporary
    directory, as the example is written (36 orbit frames, save_mesh(256)).
    Returns the launch counts of the edit_scene run."""
    import shutil

    from dreamfusion_torch.examples import edit_scene
    from dreamfusion_torch.training.jobs import params_for_nerf
    from dreamfusion_torch.utils import results
    from dreamfusion_torch.utils.backend import LocalBackend

    tmp = tempfile.mkdtemp(prefix="chip_smoke_jobs_")
    try:
        params = params_for_nerf(scene, save_name=os.path.join(tmp,
                                                               "ball.dvgo"))
        params["coarse_train"]["n_iters"] = JOB_COARSE_ITERS
        params["fine_train"]["n_iters"] = JOB_FINE_ITERS
        params["log_every"] = 100
        be = LocalBackend(root=os.path.join(tmp, "jobs"))
        job_log = os.path.join(tmp, "job.log")
        sys.stdout.flush()
        saved = os.dup(1)
        t0 = time.perf_counter()
        with open(job_log, "w") as f:     # the job's stdout, read below
            os.dup2(f.fileno(), 1)
            try:
                rc = be.submit("dreamfusion_torch.training.jobs:train_model",
                               params)
            finally:
                os.dup2(saved, 1)
                os.close(saved)
        t_job = time.perf_counter() - t0
        with open(job_log) as f:
            lines = f.read().splitlines()
        for ln in lines[-6:]:
            log(f"[jobs] job: {ln[:200]}")
        if rc != 0:
            raise AssertionError(f"the train_model job exited {rc}")
        [job_dir] = [os.path.join(be.root, d) for d in os.listdir(be.root)]
        job = results.load_job(job_dir)
        psnr = job["metrics"]["test/psnr"][-1]
        hashes = [ln.split()[-1] for ln in lines if "model weight hash:" in ln]
        dvgo = os.path.join(job_dir, "ball.dvgo")
        log(f"[jobs] LocalBackend.submit(train_model, params_for_nerf(<ball "
            f"scene>), {JOB_COARSE_ITERS} coarse + {JOB_FINE_ITERS} fine "
            f"iterations): rc {rc}, wall {t_job:.1f} s (the subprocess's "
            f"start, load_data, both stages, the test PSNR and the .dvgo); "
            f"job directory {sorted(os.listdir(job_dir))}; test/psnr "
            f"{psnr:.3f} dB; weight hash {hashes[-1] if hashes else None}")
        if not (math.isfinite(psnr) and len(hashes) == 1
                and len(hashes[0]) == 64 and os.path.exists(dvgo)
                and job["params"]):
            raise AssertionError("the job directory is incomplete")

        walls = {}
        plain = edit_scene.Trainer

        class TimedTrainer(plain):
            """edit_scene's Trainer, each call's wall recorded."""

        for meth in ("train", "test", "save_mesh"):
            def timed(self, *a, _m=meth, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = getattr(plain, _m)(self, *a, **kw)
                torch.cuda.synchronize()
                walls[_m] = time.perf_counter() - t
                return out
            setattr(TimedTrainer, meth, timed)

        ws = os.path.join(tmp, "trial_edit")
        edit_scene.Trainer = TimedTrainer
        kcuda.reset_counts()
        t0 = time.perf_counter()
        try:
            trainer = edit_scene.main(["--pretrained_dvgo", dvgo, "--iters",
                                       "3", "--workspace", ws])
        finally:
            edit_scene.Trainer = plain
        torch.cuda.synchronize()
        t_edit = time.perf_counter() - t0
        counts = dict(kcuda.launch_counts)
        frames = [p for p in os.listdir(os.path.join(ws, "results"))
                  if p.endswith("_rgb.png")]
        mesh = os.path.join(ws, "mesh", "mesh.obj")
        losses = torch.stack(trainer.loss_history).float().cpu()
        log(f"[jobs] edit_scene --pretrained_dvgo <the job's .dvgo> --iters 3 "
            f"(guidance {trainer.cfg.guidance}, sd_weights "
            f"{trainer.cfg.sd_weights}): {t_edit:.1f} s in all; train "
            f"{walls['train']:.1f} s (losses "
            + " ".join(f"{float(v):.4g}" for v in losses)
            + f"), test(36) {walls['test']:.1f} s ({len(frames)} frames of "
            f"{trainer.cfg.H}x{trainer.cfg.W}), save_mesh(256) "
            f"{walls['save_mesh']:.1f} s ({os.path.getsize(mesh) / 2 ** 20:.1f}"
            f" MiB OBJ); kernels {json.dumps(counts)}")
        if len(frames) != 36 or not bool(torch.isfinite(losses).all()):
            raise AssertionError("edit_scene: frames or losses are off")
        del trainer
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


def phase_kernels(trainer, counts, captured=None, o2_trainer=None,
                  opt_trainer=None):
    """Every kernel against its plain version; returns the entries of the
    {"kernels": [...]} line. counts maps each path that ran ("train",
    "eval", ...) to its launch counts: an entry gives them per path and
    their sum. With the o2 phase's trainer, kernel A also at the -O2 step's
    sample positions (every one inside the box); kernel F at the options
    phase's grid (_cone_cases); kernel W at an 800x800 frame of each orbit
    (orbit_scene)."""
    from dreamfusion_torch.ops import marching
    from dreamfusion_torch.ops.grid_encoder import GridEncoderSpec
    from dreamfusion_torch.training.trainer import K_LADDER

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    if trainer is not None:
        x, valid, K, M = _real_positions(trainer)
        x_dense, valid_dense, _, _ = _real_positions(trainer, dense=True)
        spec = trainer.model.enc_spec
    else:                       # --phases without train: main-path-sized data
        x = torch.rand(4096 * 40, 3, device=dev, generator=gen) * 2 - 1
        x_dense = torch.rand(4096 * 128, 3, device=dev, generator=gen) * 2 - 1
        valid = valid_dense = None
        K, M = 64, None
        spec = GridEncoderSpec(num_levels=16, level_dim=2, base_resolution=16,
                               log2_hashmap_size=16, desired_resolution=2048,
                               gridtype="tiled")
    sizes = spec.geometry[2]
    log(f"[kernels] main-path budgets K={K} M={M}; level sizes {sizes}")
    # steps 0-15 query all N x K samples, later steps the compacted M
    a_dense, _ = check_grid_encoder(spec, x_dense, valid_dense,
                                    "dense steps", gen, timed=True)
    a_comp, (base, w, cot, consts) = check_grid_encoder(
        spec, x, valid, "compacted steps", gen, timed=True)
    distinct, runs = grid_encoder_aggregation(base, cot)
    log("[kernels] A compacted steps, per level: mean distinct rows / runs "
        "of one row among a 32-sample warp's live lanes: " + ", ".join(
            f"{l}: {d:.2f} / {r:.2f}" for l, (d, r) in
            enumerate(zip(distinct, runs))))
    k1b = GridEncoderSpec(num_levels=1, level_dim=2, base_resolution=15,
                          log2_hashmap_size=16, gridtype="tiled")
    assert k1b.table_size == 4096
    a_k1b, _ = check_grid_encoder(k1b, x, valid, "T=4096 (the K1b row)",
                                  gen, timed=True)
    a_k1b["replaces"] = K1B_REPLACES
    a_o2 = None
    if o2_trainer is not None:
        x_o2 = _o2_positions(o2_trainer)
        a_o2, _ = check_grid_encoder(o2_trainer.model.enc_spec, x_o2, None,
                                     "-O2 steps (all inside)", gen,
                                     timed=True)
    # kernel H at the staged eval's shape (a group's 131,072 samples of the
    # bf16 table) and at the occupancy refresh's (a full 128^3 refresh, f32)
    emb = (spec.init(gen, dev) * 1e3).contiguous()
    h_eval = check_grid_encoder_fwd(spec, emb.to(torch.bfloat16),
                                    x_dense[:131_072].contiguous(),
                                    "eval group")
    cells, _ = marching.grid_cells(128, None, dev)
    h_refresh = check_grid_encoder_fwd(
        spec, emb, cells * (1 - 1 / 128) + (torch.rand(
            cells.shape, device=dev, generator=gen) * 2 - 1) / 128,
        "128^3 refresh")
    # kernel E at the hashgrid phase's inputs, and at a 4-level hash spec
    # whose tables are tiny (many updates per row)
    h_spec, _, h_x, _ = _hashgrid_inputs(dev)
    e = check_grid_encoder_rows(h_spec, h_x, "hashgrid phase", gen, timed=True)
    small = GridEncoderSpec(input_dim=3, num_levels=4, level_dim=2,
                            base_resolution=8, per_level_scale=1.5,
                            log2_hashmap_size=9, gridtype="hash")
    check_grid_encoder_rows(small, h_x[:65536], "4 levels of <= 512 rows",
                            gen, timed=False)
    # every K of the trainer's ladder up to the main path's grid_K
    grid_K = trainer.cfg.grid_K if trainer is not None else 128
    for k in K_LADDER:
        if k <= grid_K and k != K:
            check_composite(4096, k, gen, dev, timed=False)
    bf, bb = check_composite(4096, K, gen, dev, timed=True)
    check_composite_crossing(4096, 128, dev)
    # the UNet's self-attention over 64x64 latents (CFG batch 2, 8 heads of
    # 40, no gradient) and the VAE mid-block's (1 head of 512, gradient)
    unet_attn = check_attention(2, 4096, 8, 40, gen, dev, grad=False)
    vae_attn = check_attention(1, 4096, 1, 512, gen, dev, grad=True)
    cone = [check_march_cone(*case, timed=True)
            for case in _cone_cases(opt_trainer, gen)]
    # kernel G at a pretraining step's shapes: the density at all 8,192 x
    # 954 samples (cotangent 0 past the box), k0 at those inside it
    x01, oob = dvgo_ring_samples(8192, 0)
    g_density = check_grid_sample("density", 1, x01, ~oob, gen)
    g_k0 = check_grid_sample("k0", 12, x01[~oob].contiguous(),
                             torch.ones_like(oob[~oob]), gen)
    del x01, oob
    # kernel W on the flagged groups of an 800^2 frame of both orbits (the
    # eval phase's trained asset, when it ran, for the grid orbit)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_w_") as tmp:
        grid = ((trainer.cfg, trainer.model, trainer.grid_state)
                if trainer is not None else orbit_scene("grid_sd15", tmp))
        window = [check_march_window("grid orbit", *grid),
                  check_march_window("edit orbit",
                                     *orbit_scene("dvgo_sd15", tmp))]
    results = [("grid_encoder_bwd", a_dense), ("grid_encoder_bwd", a_comp),
               ("grid_encoder_bwd", a_k1b),
               *([("grid_encoder_bwd", a_o2)] if a_o2 is not None else []),
               ("grid_encoder_bwd_rows", e),
               ("grid_encoder_fwd", h_eval), ("grid_encoder_fwd", h_refresh),
               ("composite_fwd", bf),
               ("composite_bwd", bb), ("attention_fwd", unet_attn["fwd"]),
               ("attention_fwd", vae_attn["fwd"]),
               ("attention_bwd", vae_attn["bwd"]),
               *(("march_cone", c) for c in cone),
               *(("march_window", w) for w in window),
               *((f"grid_sample_{way}", g[way]) for g in (g_density, g_k0)
                 for way in ("fwd", "bwd"))]
    # the eval's kernels at the inputs its frame gave them: C at every
    # compact budget the groups used (timed at the most used), D at the
    # frame's classify probes
    if captured is None:
        log("[kernels] C and D skipped: they are checked at the eval "
            "phase's inputs, and the eval phase did not run")
    else:
        by_use = sorted(captured["C"].items(), key=lambda kv: -kv[1][0])
        for M, (n, (samples, cmap, N, T_thresh)) in by_use:
            label = f"{n} group(s) at M={M:,}"
            c = check_composite_compact(samples, cmap, N, T_thresh, label)
            c["bitwise_b_fwd"] = check_compact_vs_b_fwd(samples, cmap, N,
                                                        T_thresh, label)
            results.append(("composite_compact", c))
        check_compact_crossing(4096, 128, dev)
        results.append(("probe_select_small", check_probe(*captured["D"])))
    # launches are counted per wrapper, so each entry of a name carries the
    # name's count; the entries after its first are other shapes of the
    # same kernel, marked shape_variant, and a sum over the line skips them
    entries, seen = [], set()
    for name, res in results:
        per_path = {f"launches_{path}": n.get(name, 0)
                    for path, n in counts.items()}
        entries.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name],
                        "launches": sum(per_path.values()), **per_path,
                        "shape_variant": name in seen, **res})
        seen.add(name)
    return entries


def _profiled(fn, reps: int, label: str, spans, top: int = 15):
    """torch.profiler over reps calls of fn: device time per span (names
    starting with one of spans) and per kernel (the `top` largest), the
    busy share and the device launches per call; and, with the recorder
    on, the device time launched under each of its spans (autograd's
    thread included) and the syncs per span."""
    from torch.profiler import ProfilerActivity, profile

    from dreamfusion_torch import trace

    torch.cuda.synchronize()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        trace.enable()
        try:
            for _ in range(reps):
                fn()
        finally:
            trace.disable()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launched = trace.launched_by_span(
        prof.events(), prof.profiler.kineto_results.trace_start_ns())
    recorded = trace.table()
    trace.reset()
    for name, sec in sorted(launched.items(), key=lambda kv: -kv[1]):
        row = recorded.get(name, {})
        log(f"[profile] recorder span {name}: device time launched "
            f"{sec * 1e3 / reps:.2f} ms/{label}, syncs "
            f"{row.get('syncs', 0) / reps:.2f}/{label}")
    events = prof.key_averages()

    def dev_self(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) / 1e3

    def dev_total(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0)) / 1e3

    kernels = [e for e in events if str(e.device_type).endswith("CUDA")
               and not e.key.startswith(spans)]
    kernel_ms = sum(dev_self(e) for e in kernels)
    log(f"[profile] {reps} x {label} under the profiler: wall "
        f"{wall_ms / reps:.2f} ms/{label}, device kernels "
        f"{kernel_ms / reps:.2f} ms/{label}, busy share "
        f"{kernel_ms / wall_ms:.3f}")
    for e in sorted((e for e in events if e.key.startswith(spans)
                     and str(e.device_type).endswith("CPU")),
                    key=lambda e: -e.cpu_time_total):
        log(f"[profile] span {e.key}: host {e.cpu_time_total / 1e3 / reps:.2f} "
            f"ms/{label}, device time of its kernels "
            f"{dev_total(e) / reps:.2f} ms/{label}")
    for e in sorted(kernels, key=dev_self, reverse=True)[:top]:
        log(f"[profile] kernel {dev_self(e) / reps:8.3f} ms/{label} x"
            f"{e.count // reps:<5d} {e.key[:90]}")
    log(f"[profile] kernel launches per {label}: "
        f"{sum(e.count for e in kernels) // reps}")
    # the port's own kernels: the __global__ functions of its sources
    own, by_src = [], {}
    sources = _own_kernels()
    for e in kernels:
        src = _own_source(e.key, sources)
        if src:
            own.append((e, e.key.removeprefix("void ").split("::", 1)[-1]
                        .split("(")[0]))
            by_src[src] = by_src.get(src, 0.0) + dev_self(e) / reps
    own.sort(key=lambda en: -dev_self(en[0]))
    log(f"[profile] hand-written kernels {sum(by_src.values()):.3f} ms/{label} ("
        + ", ".join(f"{src} {ms:.3f}" for src, ms in by_src.items()) + "): "
        + ", ".join(f"{name} {dev_self(e) / reps:.3f} x{e.count / reps:.3g}"
                    for e, name in own))


def _own_kernels():
    """{name of a __global__ function: its source} over the port's CUDA
    sources (dreamfusion_torch/csrc)."""
    import re

    found = {}
    for src in sorted(set(kcuda.SOURCES.values())):
        text = (kcuda.CSRC_DIR / src).read_text()
        for name in re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                               r"\s*)?(\w+)\s*\(", text):
            found[name] = src
    return found


def _own_source(key: str, sources):
    """The source of the profiler's kernel `key` when it is one of the
    port's __global__ functions (sources: _own_kernels()), else None."""
    key = key.removeprefix("void ")
    name = key.split("::", 1)[-1].split("(")[0].split("<")[0]
    if key.startswith("(anonymous namespace)::"):
        return sources.get(name)
    return None


def phase_profile(trainers, steps: int = 3):
    """For each (label, trainer): train steps under torch.profiler (the
    eval and edit phases profile their frame), and the -O2 trainer's
    orbit frame 1."""
    for label, trainer in trainers:
        _profiled(trainer.train_step, steps, f"{label} step",
                  ("step/", "grid_"))
        if trainer.renderer == "stratified":
            cfg = trainer.cfg
            _profiled(lambda: trainer._render_orbit_frame(
                1, cfg.test_size, cfg.H, cfg.W), 1, f"{label} frame",
                ("eval/",))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases",
                   default="build,small,train,eval,hashgrid,edit,o2,options,"
                           "dp,txt2img,export,gui,pretrain,sd_dir,zoo,jobs,"
                           "kernels")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup", type=int, default=4)
    args = p.parse_args(argv)
    phases = args.phases.split(",")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script checks "
              "the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import dreamfusion_torch  # noqa: F401  (fails outside a checkout)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; matmul tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn tf32 "
        f"{torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    trainer, edit_trainer, o2_trainer, opt_trainer = None, None, None, None
    counts, captured = {}, None
    if "build" in phases:
        phase_build()
    if "small" in phases:
        phase_small()
        small_shampoo()
    if "train" in phases:
        trainer, counts["train"] = phase_train(args.steps, args.warmup)
    if "eval" in phases:
        if trainer is None:
            raise SystemExit("the eval phase renders the train phase's asset: "
                             "add train to --phases")
        counts["eval"], captured = phase_eval(trainer)
    if "hashgrid" in phases:
        counts["hashgrid"] = phase_hashgrid()
    if "edit" in phases:
        counts["edit"], counts["edit_eval"], edit_trainer = phase_edit(
            trainer.guidance if trainer is not None else None)
    if "o2" in phases:
        (counts["o2"], counts["o2_eval"], counts["config1"],
         o2_trainer) = phase_o2(trainer.guidance if trainer is not None
                                else None)
    if "options" in phases:
        (counts["options"], counts["options_eval"], counts["shampoo"],
         opt_trainer) = phase_options(trainer.guidance if trainer is not None
                                      else None)
    if "dp" in phases:
        counts["dp"] = phase_dp()
    guidance = trainer.guidance if trainer is not None else None
    if guidance is None and {"txt2img", "export", "gui",
                             "pretrain"} & set(phases):
        from dreamfusion_torch.guidance.sd.sds import build_sd_guidance

        # one SD random-full (bf16) for the slice-10 phases and the
        # pretrain phase's editing steps, as the train phase's trainer
        # would hold
        guidance = build_sd_guidance(
            "random-full", dtype=torch.bfloat16, device=torch.device("cuda"),
            generator=torch.Generator(device="cuda").manual_seed(0))
    if "txt2img" in phases:
        counts["txt2img"] = phase_txt2img(guidance)
    if "export" in phases:
        counts["export"] = phase_export(trainer if trainer is not None
                                        else export_trainer(guidance))
    if "gui" in phases:
        counts["gui"] = phase_gui(guidance)
    if "pretrain" in phases:
        counts["pretrain"], counts["pretrain_edit"] = phase_pretrain(guidance)
    if "sd_dir" in phases:
        counts["sd_dir"] = phase_sd_dir()
    if {"zoo", "jobs"} & set(phases):
        import shutil

        from dreamfusion_torch.datasets import load_data

        scene_tmp = tempfile.mkdtemp(prefix="chip_smoke_ball_")
        try:
            scene = os.path.join(scene_tmp, "ball")
            t1 = time.perf_counter()
            write_ball_scene(scene)
            log(f"[zoo] ball scene written in the Blender layout in "
                f"{time.perf_counter() - t1:.1f} s")
            if "zoo" in phases:
                counts["zoo"] = phase_zoo(load_data(
                    {"dataset_type": "blender", "datadir": scene}))
            if "jobs" in phases:
                counts["jobs"] = phase_jobs(scene)
        finally:
            shutil.rmtree(scene_tmp, ignore_errors=True)
    entries = (phase_kernels(trainer, counts, captured, o2_trainer,
                             opt_trainer)
               if "kernels" in phases else [])
    if "profile" in phases:
        phase_profile([(label, t) for label, t in (("grid", trainer),
                                                   ("edit", edit_trainer),
                                                   ("o2", o2_trainer))
                       if t is not None])
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
