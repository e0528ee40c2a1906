"""JAX-package variables -> reference-named torch state dicts.

The port's own copy of the JAX package's exporters
(``export_i3res50_state_dict`` and ``export_mgfn_state_dict`` in its
``utils/convert.py``). Each function takes the ``{"params", "batch_stats"}``
tree as nested dicts of numpy arrays and returns the state dict that
``load_state_dict`` takes on the port's models (and the reference's):

- flax Conv3d kernel (T, H, W, I, O) -> torch (O, I, T, H, W)
- flax Conv1d kernel (K, I, O)       -> torch (O, I, K)
- flax Dense kernel (I, O)           -> torch Linear (O, I)
- BN scale/bias + batch_stats mean/var -> weight/bias/running_mean/running_var
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _conv3d(w: Any) -> torch.Tensor:
    return _t(np.transpose(np.asarray(w), (4, 3, 0, 1, 2)))


def _conv1d(w: Any) -> torch.Tensor:
    return _t(np.transpose(np.asarray(w), (2, 1, 0)))


def _bn(sd: Dict[str, torch.Tensor], key: str, p: Mapping, s: Mapping) -> None:
    sd[key + ".weight"] = _t(p["scale"])
    sd[key + ".bias"] = _t(p["bias"])
    sd[key + ".running_mean"] = _t(s["mean"])
    sd[key + ".running_var"] = _t(s["var"])
    sd[key + ".num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def i3res50_state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """I3Res50 variables -> ``conv1``/``bn1``/``layer{L}.{i}...`` names."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    sd["conv1.weight"] = _conv3d(params["stem"]["conv"]["kernel"])
    _bn(sd, "bn1", params["stem"]["bn"], stats["stem"]["bn"])
    idx_of = {"branch_a": "1", "branch_b": "2", "branch_c": "3"}
    for name, node in params.items():
        if not name.startswith("stage"):
            continue
        stage = int(name[5])
        block = int(name.split("block")[1])
        base = f"layer{stage}.{block}"
        for sub, p in node.items():
            snode = stats[name][sub]
            if sub == "proj":
                sd[base + ".downsample.0.weight"] = _conv3d(p["conv"]["kernel"])
                _bn(sd, base + ".downsample.1", p["bn"], snode["bn"])
            elif sub in idx_of:
                i = idx_of[sub]
                sd[base + f".conv{i}.weight"] = _conv3d(p["conv"]["kernel"])
                _bn(sd, base + f".bn{i}", p["bn"], snode["bn"])
            else:
                raise KeyError(f"{name}/{sub}: not part of the ported i3res50")
    return sd


_BRANCH_OF_CONV = {"conv1": "branch_a", "conv2": "branch_b", "conv3": "branch_c",
                   "downsample.0": "proj"}


def act_scale_key(module_name: str) -> str:
    """Torch conv module name -> the JAX package's int8 act-scale key:
    ``conv1`` -> ``stem``, ``layer{L}.{i}.conv{1,2,3}`` ->
    ``stage{L}_block{i}/branch_{a,b,c}``, ``layer{L}.{i}.downsample.0`` ->
    ``stage{L}_block{i}/proj`` (the names ``i3res50_state_dict_from_flax``
    maps between)."""
    if module_name == "conv1":
        return "stem"
    layer, block, conv = module_name.split(".", 2)
    if not layer.startswith("layer") or conv not in _BRANCH_OF_CONV:
        raise KeyError(f"{module_name}: not a conv of the ported i3res50")
    return f"stage{layer[5:]}_block{block}/{_BRANCH_OF_CONV[conv]}"


def block_act_scales(scales: Mapping[str, float], stage: int, block: int) -> Dict[str, float]:
    """The scales of one bottleneck, by branch name (``branch_a`` ...
    ``proj``), from a model-wide scales dict."""
    prefix = f"stage{stage}_block{block}/"
    return {k[len(prefix):]: v for k, v in scales.items() if k.startswith(prefix)}


def mgfn_state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """MGFN variables -> the reference's HF-style names."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}

    def conv1d(key: str, node: Mapping, bias: bool = True) -> None:
        sd[key + ".weight"] = _conv1d(node["kernel"])
        if bias:
            sd[key + ".bias"] = _t(node["bias"])

    def chan_ln(key: str, node: Mapping) -> None:
        sd[key + ".g"] = _t(np.asarray(node["g"]).reshape(1, -1, 1))
        sd[key + ".b"] = _t(np.asarray(node["b"]).reshape(1, -1, 1))

    backbone = params["backbone"]
    for name in ("to_tokens", "to_mag"):
        conv1d(f"backbone.amplifier.{name}", backbone["amplifier"][name])
    for name, node in backbone.items():
        if not name.startswith("stage"):
            continue
        stage = int(name[5:].split("_")[0])
        block = int(name.split("block")[1])
        base = f"backbone.layers.{stage}.{block}"
        if "scc" not in node:  # Intermediate
            chan_ln(base + ".layer_norm", node["norm"])
            conv1d(base + ".conv", node["conv"])
            continue
        conv1d(base + ".scc", node["scc"])
        attn = node["attention"]
        if "g" in attn["norm"]:  # glance: channel LayerNorm
            chan_ln(base + ".attention.norm", attn["norm"])
            conv1d(base + ".attention.to_qkv", attn["to_qkv"], bias=False)
        else:  # focus: BatchNorm1d
            _bn(sd, base + ".attention.norm", attn["norm"],
                stats["backbone"][name]["attention"]["norm"])
            conv1d(base + ".attention.to_v", attn["to_v"], bias=False)
            conv1d(base + ".attention.rel_pos", attn["rel_pos"])
        conv1d(base + ".attention.to_out", attn["to_out"])
        chan_ln(base + ".ffn.layer_norm", node["ffn"]["norm"])
        conv1d(base + ".ffn.in_conv", node["ffn"]["in_conv"])
        conv1d(base + ".ffn.out_conv", node["ffn"]["out_conv"])
    sd["layer_norm.weight"] = _t(params["head_norm"]["scale"])
    sd["layer_norm.bias"] = _t(params["head_norm"]["bias"])
    sd["fc.weight"] = _t(np.asarray(params["fc"]["kernel"]).T)
    sd["fc.bias"] = _t(params["fc"]["bias"])
    return sd
