"""metro_pose3d_tpu_torch: the PyTorch + CUDA port of metro_pose3d_tpu.

The single-person serving path and the training path, in one process or
data-parallel over a `torch.distributed` group (`parallel/`), run here on
NVIDIA Hopper GPUs: uint8 crops (or uint8 source tiles and warp
parameters) -> ResNet (v2 or v1.5, bottleneck or basic block, SAME, torch
or Keras padding) with a dilated final stage -> metric volumetric (or 2.5D)
and 2D heatmap heads -> soft-argmax -> flip TTA -> absolute reconstruction;
and on-device augmentation -> losses -> Adam, with checkpoints and the
ImageNet warm start. Hand-written CUDA kernels carry them: the stem max
pool and its backward (`ops/pool.py`), the crop warp (`ops/warp.py`) and the
occluder paste (`ops/occlusion.py`), from the sources in `csrc/`; `probes/`
holds measurement kernels that no path calls. On CPU tensors every kernel
wrapper runs its plain PyTorch version, which the tests compare against the
JAX package. Entry points run on the card unless the caller passes
`device="cpu"`.

The package imports torch and never jax or flax, and nothing of the JAX
package: `config`, `reference_constants` and `geom` are its own copies.
"""
