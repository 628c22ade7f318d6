"""Model export and import (`metro_pose3d_tpu/export.py`): a crop-in,
skeleton-out inference bundle.

The bundle is `config.json`, in the JAX package's layout
(`{"config": <the config as a dict>, "joint_info": <name>}`, so either
package reads the other's config), and `model.pt`, the port's model state
dict (with each `QuantConv`'s calibrated `amax` under int8). `load_exported`
rebuilds the model on a device and returns `make_predict_fn`'s crop-in
function. `aot_compile` fixes that function to one batch shape and, on the
card, captures it as a CUDA graph, so that a serving process pays the
first call's cost (cuDNN's plans, the kernels' build, the graph) when it
loads, not on its first request.
"""
from __future__ import annotations

import dataclasses
import json
import os

import torch

from metro_pose3d_tpu_torch.config import Config, apply_overrides
from metro_pose3d_tpu_torch.device import resolve_device
from metro_pose3d_tpu_torch.evaluation.engine import make_predict_fn
from metro_pose3d_tpu_torch.geom.joints import get_joint_info
from metro_pose3d_tpu_torch.models.metro import MetroModel
from metro_pose3d_tpu_torch.ops import bn, int8, pool, warp

WEIGHTS = "model.pt"
WARMUP_CALLS = 2  # eager calls on a side stream before the capture
# the kernel wrappers' launch counts: a capture records launches that run
# only when the graph replays
_LAUNCH_COUNTS = (pool.KERNEL_LAUNCHES, warp.KERNEL_LAUNCHES, int8.KERNEL_LAUNCHES,
                  bn.KERNEL_LAUNCHES)


def export_model(cfg: Config, model: MetroModel, out_dir: str,
                 joint_info_name: str = "h36m_17") -> str:
    """Write `model` and `cfg` as a bundle into `out_dir`; returns it."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({"config": dataclasses.asdict(cfg), "joint_info": joint_info_name}, f,
                  indent=2)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(out_dir, WEIGHTS))
    return out_dir


def load_exported(out_dir: str, flip_tta: bool | None = None, device=None):
    """-> (cfg, model, predict_fn(model, crops_uint8 [B,S,S,3], intrinsics
    [B,3,3])), the model in eval mode on `device` (default: the card; a
    RuntimeError where CUDA is absent)."""
    with open(os.path.join(out_dir, "config.json")) as f:
        meta = json.load(f)
    flat = {f"{section}.{name}": str(value)
            for section, fields in meta["config"].items() for name, value in fields.items()}
    cfg = apply_overrides(Config(), flat)
    ji = get_joint_info(meta["joint_info"])
    model = MetroModel(cfg.model)
    state = torch.load(os.path.join(out_dir, WEIGHTS), map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)
    model = model.to(resolve_device(device)).eval()
    root = ji.names.index("pelv") if "pelv" in ji.names else 0
    fn = make_predict_fn(cfg, ji.mirror_mapping, root_index=root, flip_tta=flip_tta)
    return cfg, model, fn


class CompiledPredict:
    """`aot_compile`'s callable: `compiled(model, crops_uint8, intrinsics)`
    for crops [B, S, S, 3] uint8 and intrinsics [B, 3, 3] float32 (tensors
    or arrays, on any device) of the compiled shape, and the model object it
    was compiled for; anything else raises, as the JAX package's compiled
    executable refuses other shapes.

    On a CUDA model each call copies the inputs into the graph's static
    buffers, replays the graph and returns clones of its static outputs (a
    later replay changes nothing that a caller holds), and adds the kernel
    launches of one replay (`launches`) to the wrappers' counts. On a CPU
    model it runs the predict function eagerly."""

    def __init__(self, fn, model: MetroModel, batch_size: int, proc_side: int):
        self.fn, self.model = fn, model
        self.device = next(model.parameters()).device
        self.crops_spec = ((batch_size, proc_side, proc_side, 3), torch.uint8)
        self.intrinsics_spec = ((batch_size, 3, 3), torch.float32)
        self.graph, self.launches = None, []
        if self.device.type == "cuda":
            self._capture(batch_size, proc_side)

    def _capture(self, b: int, side: int) -> None:
        dev = self.device
        self._crops = torch.zeros((b, side, side, 3), dtype=torch.uint8, device=dev)
        k = torch.tensor([[float(side), 0.0, side / 2], [0.0, float(side), side / 2],
                          [0.0, 0.0, 1.0]])
        self._intrinsics = k.expand(b, 3, 3).contiguous().to(dev)
        # the first calls make what the capture must find ready: cuDNN's
        # plans, the engine's per-device constants, the kernels' one-time
        # attributes and QK1's TMA encoder entry point
        side_stream = torch.cuda.Stream(dev)
        side_stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side_stream):
            for _ in range(WARMUP_CALLS):
                self.fn(self.model, self._crops, self._intrinsics)
        torch.cuda.current_stream(dev).wait_stream(side_stream)
        before = [dict(c) for c in _LAUNCH_COUNTS]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                self._out = self.fn(self.model, self._crops, self._intrinsics)
        except Exception as e:
            raise RuntimeError(f"aot_compile: capturing the predict function at batch {b}, "
                               f"side {side} into a CUDA graph failed: {e}") from e
        finally:
            # the capture ran no kernel: take its counts back, and count
            # them at each replay instead
            self.launches = [{key: n - was[key] for key, n in counts.items() if n != was[key]}
                             for counts, was in zip(_LAUNCH_COUNTS, before)]
            for counts, was in zip(_LAUNCH_COUNTS, before):
                counts.update(was)
        self.graph = graph

    def _input(self, x, spec, name: str) -> torch.Tensor:
        x = torch.as_tensor(x)
        shape, dtype = spec
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise TypeError(f"{name}: compiled for {dtype} {list(shape)}, "
                            f"got {x.dtype} {list(x.shape)}")
        return x

    def __call__(self, model, crops_uint8, intrinsics) -> dict:
        if model is not self.model:
            raise ValueError("aot_compile: this predict function was compiled for another "
                             "model object")
        crops = self._input(crops_uint8, self.crops_spec, "crops")
        intr = self._input(intrinsics, self.intrinsics_spec, "intrinsics")
        if self.graph is None:
            return self.fn(model, crops.to(self.device), intr.to(self.device))
        with torch.no_grad():
            self._crops.copy_(crops)
            self._intrinsics.copy_(intr)
        self.graph.replay()
        for counts, delta in zip(_LAUNCH_COUNTS, self.launches):
            for key, n in delta.items():
                counts[key] += n
        with torch.inference_mode():
            return {key: v.clone() for key, v in self._out.items()}


def aot_compile(fn, model: MetroModel, batch_size: int, proc_side: int) -> CompiledPredict:
    """The crop-in predict `fn` (`load_exported`'s, or `make_predict_fn`'s
    with `from_tiles=False`) for one fixed batch shape, for a serving cold
    start: the counterpart of the JAX package's `aot_compile(fn, variables,
    batch_size, proc_side)`. On a CUDA model the first cost is paid here:
    `fn` runs on the graph's static inputs on a side stream, then one
    `torch.cuda.CUDAGraph` captures it (PyTorch's documented recipe); a
    capture that fails raises RuntimeError, and nothing falls back to eager
    calls. The graph's memory pool holds every buffer the captured kernels
    address (QK1's TMA descriptors hold the capture's pointers into it) for
    as long as the callable lives. On a CPU model the callable runs `fn`
    eagerly behind the same checks. -> `CompiledPredict`."""
    return CompiledPredict(fn, model, batch_size, proc_side)
