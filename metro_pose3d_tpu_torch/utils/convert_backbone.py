"""ImageNet backbone weight conversion: the warm start of `train.backbone_init`
(`metro_pose3d_tpu/utils/convert_backbone.py`).

A torchvision ResNet (v1.5, post-activation) `state_dict`, or a Keras
`ResNet50V2`-family model, becomes a state dict of the port's
`models.resnet.ResNet` (names relative to the trunk, float32 numpy). The
trunk reproduces its source's feature maps only when it is built with the
source's conventions:

    torchvision: preactivation=False, conv_padding="torch", stride_position="first"
    Keras v2:    preactivation=True,  conv_padding="keras", stride_position="last",
                 v2_biases=True

Name mapping, torchvision:
    conv1.weight                  -> conv_stem.weight
    bn1.*                         -> bn_stem.{scale,bias,mean,var}
    layer{L}.{B}.conv{k}.weight   -> stage{L}_block{B+1}.conv{k}.weight
    layer{L}.{B}.bn{k}.*          -> stage{L}_block{B+1}.bn{k}.*
    layer{L}.{B}.downsample.0/1   -> proj / bn_proj
Keras layers: conv1_conv; conv{s+1}_block{b}_{preact_bn,1_conv,1_bn,2_conv,
2_bn,3_conv,0_conv}; post_bn -> conv_stem; stage{s}_block{b}.{bn_pre,conv1,
bn1,conv2,bn2,conv3,proj}; bn_final.

The `.npz` file is the JAX package's: flat keys `params:<path>` and
`stats:<path>` with slash-joined flax paths and HWIO conv kernels, so a
backbone file written by either package loads in the other.
"""
from __future__ import annotations

import numpy as np
import torch

_BN_FROM_TORCH = {"weight": "scale", "bias": "bias", "running_mean": "mean",
                  "running_var": "var"}
_KERAS_STACKS = {"resnet50v2": (3, 4, 6, 3), "resnet101v2": (3, 4, 23, 3),
                 "resnet152v2": (3, 8, 36, 3)}


def _f32(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(t, np.float32))


def _oihw(hwio) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(_f32(hwio), (3, 2, 0, 1)))


def _hwio(oihw) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(_f32(oihw), (2, 3, 1, 0)))


def torchvision_resnet_to_state_dict(state_dict, depths=(3, 4, 6, 3)) -> dict:
    """torchvision ResNet `state_dict` -> the trunk's state dict for
    `ResNet(preactivation=False)`. Values may be tensors or numpy arrays.
    Basic blocks (resnet18/34) have two convs, bottlenecks three."""
    sd = state_dict
    out = {"conv_stem.weight": _f32(sd["conv1.weight"])}

    def bn(src, dst):
        for theirs, ours in _BN_FROM_TORCH.items():
            out[f"{dst}.{ours}"] = _f32(sd[f"{src}.{theirs}"])

    bn("bn1", "bn_stem")
    for stage, n_blocks in enumerate(depths, start=1):
        for b in range(n_blocks):
            src, dst = f"layer{stage}.{b}", f"stage{stage}_block{b + 1}"
            for k in (1, 2, 3):
                if f"{src}.conv{k}.weight" in sd:
                    out[f"{dst}.conv{k}.weight"] = _f32(sd[f"{src}.conv{k}.weight"])
                    bn(f"{src}.bn{k}", f"{dst}.bn{k}")
            if f"{src}.downsample.0.weight" in sd:
                out[f"{dst}.proj.weight"] = _f32(sd[f"{src}.downsample.0.weight"])
                bn(f"{src}.downsample.1", f"{dst}.bn_proj")
    return out


def keras_resnet_v2_to_state_dict(model, depths=(3, 4, 6, 3)) -> dict:
    """Keras `ResNet50V2`-family model -> the trunk's state dict for
    `ResNet(preactivation=True, conv_padding="keras", stride_position="last",
    v2_biases=True)`. Biases live on the stem conv, each block's conv3 and
    the projection shortcuts: the convs that no BatchNorm follows. `model`
    needs `get_layer(name).get_weights()`; Keras kernels are HWIO."""
    out = {}

    def w(name):
        return model.get_layer(name).get_weights()

    def bn(src, dst):
        for ours, value in zip(("scale", "bias", "mean", "var"), w(src)):
            out[f"{dst}.{ours}"] = _f32(value)

    def conv(src, dst, bias):
        weights = w(src)
        out[f"{dst}.weight"] = _oihw(weights[0])
        if bias:
            out[f"{dst}.bias"] = _f32(weights[1])

    conv("conv1_conv", "conv_stem", True)
    for stage, n_blocks in enumerate(depths, start=1):
        for blk in range(1, n_blocks + 1):
            src, dst = f"conv{stage + 1}_block{blk}", f"stage{stage}_block{blk}"
            bn(f"{src}_preact_bn", f"{dst}.bn_pre")
            for i in (1, 2):
                conv(f"{src}_{i}_conv", f"{dst}.conv{i}", False)
                bn(f"{src}_{i}_bn", f"{dst}.bn{i}")
            conv(f"{src}_3_conv", f"{dst}.conv3", True)
            try:
                conv(f"{src}_0_conv", f"{dst}.proj", True)
            except ValueError:
                pass  # identity or subsampling shortcut: no such layer
    bn("post_bn", "bn_final")
    return out


def save_backbone_npz(state_dict: dict, path: str) -> None:
    """Write a trunk state dict in the JAX package's flat npz layout."""
    flat = {}
    for name, value in state_dict.items():
        *module, leaf = name.split(".")
        value = _f32(value)
        if leaf == "weight":
            leaf, value = "kernel", _hwio(value)
        sink = "stats" if leaf in ("mean", "var") else "params"
        flat[f"{sink}:{'/'.join((*module, leaf))}"] = value
    np.savez_compressed(path, **flat)


def load_backbone_npz(path: str) -> dict:
    """Read the JAX package's backbone npz -> a trunk state dict (numpy)."""
    out = {}
    with np.load(path) as data:
        for key in data.files:
            _, name = key.split(":", 1)
            *module, leaf = name.split("/")
            value = data[key]
            if leaf == "kernel":
                leaf, value = "weight", _oihw(value)
            out[".".join((*module, leaf))] = _f32(value)
    return out


def apply_backbone_init(model: torch.nn.Module, backbone_state: dict) -> None:
    """Copy a converted trunk state dict into `model.backbone` (parameters
    and BN statistics) in place. Leaves that the file does not name keep
    their values. Every leaf is checked, and all mismatches are reported at
    once."""
    own = model.backbone.state_dict()
    errors = []
    for name, value in backbone_state.items():
        if name not in own:
            errors.append(f"missing in model: backbone.{name}")
        elif tuple(own[name].shape) != tuple(np.shape(value)):
            errors.append(f"shape mismatch at backbone.{name}: model "
                          f"{tuple(own[name].shape)} vs init {tuple(np.shape(value))}")
    if errors:
        raise ValueError("backbone init mismatch:\n  " + "\n  ".join(errors))
    with torch.no_grad():
        for name, value in backbone_state.items():
            own[name].copy_(torch.from_numpy(_f32(value)))


def convert_torchvision_checkpoint(src_path: str, dst_path: str, depths=(3, 4, 6, 3)) -> str:
    """A torchvision `.pth` state dict -> the backbone `.npz`."""
    sd = torch.load(src_path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    save_backbone_npz(torchvision_resnet_to_state_dict(sd, depths), dst_path)
    return dst_path


def convert_keras_v2_checkpoint(dst_path: str, name: str = "resnet50v2",
                                weights: str = "imagenet") -> str:
    """Build the Keras v2 model (`weights="imagenet"` downloads them where
    there is a network) and convert it to the backbone `.npz`."""
    import tensorflow as tf

    by_name = {
        "resnet50v2": tf.keras.applications.ResNet50V2,
        "resnet101v2": tf.keras.applications.ResNet101V2,
        "resnet152v2": tf.keras.applications.ResNet152V2,
    }
    model = by_name[name](weights=weights, include_top=False)
    save_backbone_npz(keras_resnet_v2_to_state_dict(model, _KERAS_STACKS[name]), dst_path)
    return dst_path


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", required=True, help="torchvision .pth state_dict")
    ap.add_argument("--dst", required=True, help="output .npz")
    args = ap.parse_args()
    print(convert_torchvision_checkpoint(args.src, args.dst))
