"""The collectives of data-parallel training (`metro_pose3d_tpu/parallel/mesh.py`).

Under the JAX package's 1-D `data` mesh the parameters are replicated, the
batch is split over the devices, and XLA inserts the collectives: the sum
over the batch inside batch norm's moments and the loss's means, and the
gradient sum. Here they are explicit, over the ranks of the
`torch.distributed` process group (`parallel/distributed.py`):

  * `global_sum`: a sum over the ranks that autograd differentiates (its
    backward sums the ranks' gradients), for batch norm's moments and the
    loss's masked means;
  * `average_gradients_`: every parameter's gradient through one flat
    buffer, one collective a step;
  * `check_replicas`: the step count and the model's parameters and
    statistics are bit for bit the same on every rank.

Every rank back-propagates the global loss. The backward of each
`global_sum` adds the other ranks' shares, so each rank's gradient is the
world size times the part its own rows contribute, and the mean of the
ranks' gradients is the gradient of the global loss.

`make_mesh`, `shard_batch`, `put_batch` and `put_stacked_batch` have no
counterparts: each rank feeds its own rows, and no global array exists.
The model and the step reach the group through this module alone:
`in_group` and `process_index_count` are those of `parallel/distributed.py`.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from metro_pose3d_tpu_torch.parallel.distributed import in_group, process_index_count


class _GlobalSum(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the gradient: the
    function of `torch.distributed.nn.functional.all_reduce`, which torch
    2.13 deprecates."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y

    @staticmethod
    def backward(ctx, grad):
        return _GlobalSum.apply(grad)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, with gradients (the backward sums the
    ranks' gradients); `x` itself without a process group."""
    if not in_group():
        return x
    return _GlobalSum.apply(x)


def average_gradients_(params) -> list:
    """Replace each parameter's gradient by its mean over the ranks, through
    one flat buffer -> the gradients. A parameter without a gradient takes
    zeros, so that every rank's buffer has the same layout."""
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat /= process_index_count()[1]
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view(g.shape))
    return grads


_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _digest(tensors) -> torch.Tensor:
    """Two int64 sums of the tensors' bits (plain, and weighted by position),
    with wrap-around: exact, so independent of the order of summation."""
    total = None
    for t in tensors:
        t = t.detach().reshape(-1)
        bits = t.view(_INT_OF_SIZE[t.element_size()]).to(torch.int64)
        pos = torch.arange(1, bits.numel() + 1, device=bits.device, dtype=torch.int64)
        d = torch.stack([bits.sum(), (bits * pos).sum()])
        total = d if total is None else total + d
    return total


def check_replicas(step: int, module: torch.nn.Module) -> None:
    """Raise unless `step` and every parameter and buffer of `module` are bit
    for bit the same on every rank: a digest of each rank, its maximum and
    minimum over the ranks compared, in one collective."""
    d = torch.cat([_digest(module.state_dict().values()),
                   torch.tensor([step], dtype=torch.int64, device=next(module.parameters()).device)])
    both = torch.cat([d, -d])
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    if not torch.equal(both[:3], -both[3:]):
        raise RuntimeError(
            f"rank {process_index_count()[0]}: the ranks' train states differ (digest of step, "
            f"parameters and statistics: max {both[:3].tolist()}, min {(-both[3:]).tolist()}); "
            f"they were not created from one seed or restored from one checkpoint")
