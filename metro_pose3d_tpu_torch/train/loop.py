"""One train step (`metro_pose3d_tpu/train/loop.py`):

    device_augment(train=True)  K1 warp, K2 occluder paste, colour jitter
    -> MetroModel in train mode  batch-statistics BN, K3 pool and its backward
    -> compute_losses -> backward
    -> gradient mean over ranks  where a process group is up
    -> global-norm clip          as optax writes it, no epsilon
    -> Adam                      rate from the schedule at the update count

The model's batch norm updates its running statistics during the forward.
The learning-rate schedule and the clip reproduce optax's, so a state
converted from the JAX package (`convert.train_state_from_flax`) takes the
same steps. `train.fused_adam` selects nothing here: it is the same
arithmetic as the optax chain, and on CUDA Adam is torch's fused kernel
either way.
"""
from __future__ import annotations

import math

import torch

from metro_pose3d_tpu_torch.config import Config
from metro_pose3d_tpu_torch.models.losses import compute_losses
from metro_pose3d_tpu_torch.parallel import mesh
from metro_pose3d_tpu_torch.pipeline.device import device_augment
from metro_pose3d_tpu_torch.utils.profiling import span


def make_lr_schedule(cfg: Config):
    """-> sched(count): the rate of the update made after `count` updates,
    as optax computes it: `join_schedules` hands count - warmup_steps to the
    decay after a linear warmup from 0, so with warmup the first rate is 0."""
    t = cfg.train
    base = t.base_lr
    if t.lr_schedule == "constant":
        def decay(count):
            return base
    elif t.lr_schedule == "cosine":
        steps = max(t.num_steps - t.warmup_steps, 1)

        def decay(count):
            return base * 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))
    elif t.lr_schedule == "exp_decay":
        def decay(count):  # optax.exponential_decay(staircase=False)
            return base if count <= 0 else base * t.lr_decay_rate ** (count / t.lr_decay_steps)
    else:
        raise ValueError(t.lr_schedule)
    if t.warmup_steps <= 0:
        return decay

    def sched(count):
        if count < t.warmup_steps:  # optax.linear_schedule(0, base, warmup_steps)
            return -base * (1.0 - max(count, 0) / t.warmup_steps) + base
        return decay(count - t.warmup_steps)

    return sched


def make_optimizer(cfg: Config, model: torch.nn.Module) -> torch.optim.Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) over the model's parameters; the
    train step sets its rate from the schedule before each update."""
    fused = next(model.parameters()).is_cuda
    return torch.optim.Adam(model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            fused=fused)


def clip_by_global_norm_(grads, max_norm: float, norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm in place: g if norm < max_norm, else
    g / norm * max_norm. Unlike `clip_grad_norm_` no epsilon is added, and
    the choice is made on the device, without a host sync."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def make_train_step(cfg: Config, root_index: int = 0, occluder_bank=None,
                    background_bank=None):
    """-> step(state, batch) -> metrics. `state` is a `train.state.TrainState`
    (updated in place, its step counted); `batch` holds device tensors in
    the `example_spec` layout. `occluder_bank` is the uint8 bank from
    `pipeline.device.pack_occluder_bank_for` (None: no occluders).
    `background_bank` is a uint8 [N,T,T,3] tensor on the step's device (None:
    no background replacement); a batch that carries "source_mask" and
    "bg_params" is composited onto it before the warp. Metrics
    are device scalars: loss, loss3d, loss2d (loss_abs with the absolute
    loss on) and grad_norm, the global norm of the unclipped gradients.

    Where a `torch.distributed` process group is up, `batch` holds this
    rank's rows of the global batch and the step is data-parallel, as the
    JAX package's step over its mesh: batch norm and the losses take the
    global batch, the gradients are averaged over the ranks in one
    collective before the norm and the clip (`parallel/mesh.py`), and Adam
    takes the same step on every rank. The first call checks that the
    ranks start from the same state. The augmentation stays per rank."""
    proc_side = cfg.model.proc_side
    clip = cfg.train.grad_clip_norm
    sched = make_lr_schedule(cfg)

    checked = False

    def step(state, batch: dict) -> dict:
        with span("train.step"):
            return _step(state, batch)

    def _step(state, batch: dict) -> dict:
        nonlocal checked
        model, opt = state.model, state.optimizer
        parallel = mesh.in_group()
        if parallel and not checked:
            mesh.check_replicas(state.step, model)
            checked = True
        model.train()
        with span("train.augment"), torch.no_grad():
            crops = device_augment(batch, proc_side, train=True, occluder_bank=occluder_bank,
                                   background_bank=background_bank)
        with span("train.forward"):
            opt.zero_grad(set_to_none=True)
            logits3d, logits2d = model(crops)
            total, parts = compute_losses(logits3d, logits2d, batch, cfg, root_index)
        with span("train.backward"):
            total.backward()
        with span("train.optimizer"):
            if parallel:
                grads = mesh.average_gradients_(model.parameters())
            else:
                grads = [p.grad for p in model.parameters() if p.grad is not None]
            norm = torch.nn.utils.get_total_norm(grads)  # optax.global_norm
            if clip > 0:
                clip_by_global_norm_(grads, clip, norm)
            for group in opt.param_groups:
                group["lr"] = sched(state.step)
            opt.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in parts.items()}
        metrics["grad_norm"] = norm.detach()
        return metrics

    return step
