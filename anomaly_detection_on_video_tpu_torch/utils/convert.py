"""JAX-package variables -> reference-named torch state dicts, and the
reference's own checkpoint layouts -> the port's names.

The ``*_from_flax`` functions are the port's own copy of the JAX package's
exporters (``export_{i3res50,mgfn,rtfm,sultani}_state_dict`` in its
``utils/convert.py``). Each takes the ``{"params", "batch_stats"}`` tree as
nested dicts of numpy arrays and returns the state dict that
``load_state_dict`` takes on the port's models (and the reference's);
``{i3d,mgfn,rtfm,sultani}_state_dict_to_flax`` are their exact inverses
(the JAX package's ``convert_*_state_dict`` layouts, what the converter
``anomaly_detection_on_video_tpu_torch.scripts.convert_checkpoint``
writes). One I3D tree serves every
variant (i3res50 with or without non-local blocks, ``i3d_8x8_r50``);
``i3d_state_dict_{from,to}_pytorchvideo`` move it to and
from pytorchvideo's ``create_resnet`` names (the ``I3D_8x8_R50.pyth``
layout):

- flax Conv3d kernel (T, H, W, I, O) -> torch (O, I, T, H, W)
- flax Conv1d kernel (K, I, O)       -> torch (O, I, K)
- flax Dense kernel (I, O)           -> torch Linear (O, I)
- BN scale/bias + batch_stats mean/var -> weight/bias/running_mean/running_var
"""

from __future__ import annotations

import re
import sys
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _array(value: Any) -> np.ndarray:
    """A state dict's tensor (or array) as a numpy array of its dtype."""
    return value.detach().cpu().numpy() if hasattr(value, "detach") else np.asarray(value)


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


def i3d_state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """I3D variables (any variant) -> ``conv1``/``bn1``/``layer{L}.{i}...``
    names, the non-local blocks' ``NonLocalBlock_0`` as
    ``layer{L}.{i}.nl.{theta,phi,g,out,bn}`` (the JAX package's
    ``export_i3res50_state_dict``)."""
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
            elif sub == "NonLocalBlock_0":
                for conv in ("theta", "phi", "g", "out"):
                    sd[base + f".nl.{conv}.weight"] = _conv3d(p[conv]["kernel"])
                    sd[base + f".nl.{conv}.bias"] = _t(p[conv]["bias"])
                _bn(sd, base + ".nl.bn", p["bn"], snode["bn"])
            elif sub in idx_of:
                i = idx_of[sub]
                sd[base + f".conv{i}.weight"] = _conv3d(p["conv"]["kernel"])
                _bn(sd, base + f".bn{i}", p["bn"], snode["bn"])
            else:
                raise KeyError(f"{name}/{sub}: not part of the ported I3D")
    return sd


_BN_TO_FLAX = {"weight": ("params", "scale"), "bias": ("params", "bias"),
               "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}
_I3D_BLOCK_MODULE = re.compile(r"^layer(\d)\.(\d+)\.(conv[123]|bn[123]|downsample\.[01]|"
                               r"nl\.(?:theta|phi|g|out|bn))$")
_NL_CONVS = ("theta", "phi", "g", "out")


def _i3d_flax_path(module: str) -> Optional[Tuple[str, ...]]:
    """A torch I3D module name -> its flax module path (ending in ``conv``,
    ``bn`` or a non-local conv's name), None for no I3D module."""
    if module in ("conv1", "bn1"):
        return ("stem", "conv" if module == "conv1" else "bn")
    m = _I3D_BLOCK_MODULE.match(module)
    if m is None:
        return None
    block, part = f"stage{m.group(1)}_block{m.group(2)}", m.group(3)
    if part.startswith("nl."):
        return (block, "NonLocalBlock_0", part[3:])
    if part.startswith("downsample"):
        return (block, "proj", "conv" if part.endswith("0") else "bn")
    return (block, {"1": "branch_a", "2": "branch_b", "3": "branch_c"}[part[-1]], part[:-1])


SKIP = object()  # a key ``_flax_variables`` drops without a word


def _flax_variables(state_dict: Mapping[str, Any], leaf_of: Callable, what: str,
                    unknown: str = "raise") -> Dict[str, Dict[str, Any]]:
    """A state dict -> flax variables, one key at a time: ``leaf_of(key,
    array)`` gives the key's ``(collection, path, array)``, ``SKIP`` for a
    key with no flax counterpart that no converter reads (BatchNorm's
    ``num_batches_tracked``), or None for a key of no part of ``what``.
    ``unknown="raise"`` raises KeyError naming every such key;
    ``"ignore"`` drops them, naming them on stderr, as the JAX package's
    lenient converters read only their own keys. ``batch_stats`` is left
    out when empty. Arrays are copies in their own dtype."""
    if unknown not in ("raise", "ignore"):
        raise ValueError(f"unknown must be raise or ignore, got {unknown!r}")
    variables: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    refused = []
    for key, value in state_dict.items():
        leaf = leaf_of(key, np.array(_array(value), copy=True))
        if leaf is SKIP:
            continue
        if leaf is None:
            refused.append(key)
            continue
        collection, path, array = leaf
        node = variables[collection]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = array
    if refused and unknown == "raise":
        raise KeyError(f"not part of the ported {what} (no flax name): {', '.join(refused)}")
    if refused:
        print(f"{what}: ignoring {len(refused)} key(s) with no flax name: {', '.join(refused)}",
              file=sys.stderr)
    if not variables["batch_stats"]:
        del variables["batch_stats"]
    return variables


def _i3d_leaf(key: str, array: np.ndarray):
    module, _, tensor = key.rpartition(".")
    path = _i3d_flax_path(module)
    if path is None:
        return None
    if path[-1] == "bn":
        if tensor == "num_batches_tracked":
            return SKIP
        if tensor in _BN_TO_FLAX:
            collection, leaf = _BN_TO_FLAX[tensor]
            return collection, path + (leaf,), array
        return None
    if tensor == "weight":
        return "params", path + ("kernel",), np.transpose(array, (2, 3, 4, 1, 0))
    if path[-1] in _NL_CONVS and tensor == "bias":
        return "params", path + ("bias",), array
    return None


def i3d_state_dict_to_flax(state_dict: Mapping[str, Any], unknown: str = "raise"
                           ) -> Dict[str, Dict[str, Any]]:
    """The port's I3D state dict (any variant) -> flax ``{"params",
    "batch_stats"}`` variables of numpy arrays, the exact inverse of
    ``i3d_state_dict_from_flax`` (the layout the JAX package's
    ``convert_i3res50_state_dict`` builds and ``convert_checkpoint --kind
    i3d`` writes, the JAX script's or the port's
    ``anomaly_detection_on_video_tpu_torch.scripts.convert_checkpoint``):
    ``conv1``/``bn1`` are ``stem/{conv,bn}``,
    ``layer{L}.{i}.conv{1,2,3}``/``bn{1,2,3}`` ``stage{L}_block{i}/branch_{a,b,c}``,
    ``downsample.{0,1}`` ``proj``, ``nl.*`` ``NonLocalBlock_0``. BatchNorm's
    ``num_batches_tracked`` has no flax counterpart and is dropped; any other
    key raises KeyError naming it (``unknown="ignore"``: dropped and named
    on stderr, as the JAX converter ignores a Kinetics head). Arrays keep
    their dtype."""
    return _flax_variables(state_dict, _i3d_leaf, "I3D", unknown)


# pytorchvideo's top-level block of each stage: with ``stage1_pool`` set (the
# reference's build) the stage-1 MaxPool is its own block 2
PYTORCHVIDEO_STAGE_BLOCKS = (1, 3, 4, 5)
_PV_BRANCH = {"branch2.conv_a": "conv1", "branch2.norm_a": "bn1", "branch2.conv_b": "conv2",
              "branch2.norm_b": "bn2", "branch2.conv_c": "conv3", "branch2.norm_c": "bn3",
              "branch1_conv": "downsample.0", "branch1_norm": "downsample.1"}
_PV_TENSORS = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")
_PV_BLOCK = re.compile(r"^blocks\.(\d+)\.res_blocks\.(\d+)\.(.+)\.([a-z_]+)$")


def i3d_state_dict_from_pytorchvideo(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A pytorchvideo ``create_resnet`` state dict (``I3D_8x8_R50.pyth``'s
    ``model_state``) -> the port's I3D names, the mapping of the JAX
    package's ``convert_pytorchvideo_resnet_state_dict``:
    ``blocks.0.{conv,norm}`` is the stem; stages are the top-level blocks
    that hold ``res_blocks``, in the order of their indices (1, 3, 4, 5 in
    the real file), each ``res_blocks.{i}.branch2.{conv,norm}_{a,b,c}`` and
    ``branch1_{conv,norm}`` a bottleneck's convs and projection. Keys of no
    such part (the classification head) are dropped, as there; ValueError
    unless exactly 4 stages are found. Tensors keep their values and
    dtypes."""
    matches = {key: _PV_BLOCK.match(key) for key in state_dict}
    stage_blocks = sorted({int(m.group(1)) for m in matches.values() if m})
    if len(stage_blocks) != 4:
        raise ValueError(f"expected 4 ResNet stages in the state dict, found block indices "
                         f"{stage_blocks}")
    stage_of = {idx: i + 1 for i, idx in enumerate(stage_blocks)}
    sd: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        for pv, ours in (("blocks.0.conv", "conv1"), ("blocks.0.norm", "bn1")):
            if key.startswith(pv + ".") and key[len(pv) + 1:] in _PV_TENSORS:
                sd[f"{ours}.{key[len(pv) + 1:]}"] = _t(_array(value))
        m = matches[key]
        if m and m.group(3) in _PV_BRANCH and m.group(4) in _PV_TENSORS:
            base = f"layer{stage_of[int(m.group(1))]}.{m.group(2)}"
            sd[f"{base}.{_PV_BRANCH[m.group(3)]}.{m.group(4)}"] = _t(_array(value))
    return sd


def i3d_state_dict_to_pytorchvideo(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's I3D names -> pytorchvideo's ``create_resnet`` names, the
    inverse of ``i3d_state_dict_from_pytorchvideo`` (the JAX package's
    ``export_pytorchvideo_resnet_state_dict``): stages at blocks 1, 3, 4
    and 5. A key with no pytorchvideo name (a non-local block's) raises
    KeyError."""
    ours_to_pv = {v: k for k, v in _PV_BRANCH.items()}
    sd: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        module, _, tensor = key.rpartition(".")
        if module in ("conv1", "bn1"):
            sd[f"blocks.0.{'conv' if module == 'conv1' else 'norm'}.{tensor}"] = _t(_array(value))
            continue
        layer, block, branch = (module.split(".", 2) + ["", ""])[:3]
        if not layer.startswith("layer") or branch not in ours_to_pv:
            raise KeyError(f"{key}: no pytorchvideo name (not part of i3d_8x8_r50)")
        index = PYTORCHVIDEO_STAGE_BLOCKS[int(layer[5:]) - 1]
        sd[f"blocks.{index}.res_blocks.{block}.{ours_to_pv[branch]}.{tensor}"] = _t(_array(value))
    return sd


BRANCH_OF_CONV = {"conv1": "branch_a", "conv2": "branch_b", "conv3": "branch_c",
                   "downsample.0": "proj"}


def act_scale_key(module_name: str) -> str:
    """Torch conv module name -> the JAX package's int8 act-scale key:
    ``conv1`` -> ``stem``, ``layer{L}.{i}.conv{1,2,3}`` ->
    ``stage{L}_block{i}/branch_{a,b,c}``, ``layer{L}.{i}.downsample.0`` ->
    ``stage{L}_block{i}/proj`` (the names ``i3d_state_dict_from_flax``
    maps between)."""
    if module_name == "conv1":
        return "stem"
    layer, block, conv = module_name.split(".", 2)
    if not layer.startswith("layer") or conv not in BRANCH_OF_CONV:
        raise KeyError(f"{module_name}: not a conv of the ported i3res50")
    return f"stage{layer[5:]}_block{block}/{BRANCH_OF_CONV[conv]}"


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


def rtfm_state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """RTFM variables -> the official release's names (the JAX package's
    ``export_rtfm_state_dict``): flax ``dilated{1,2,4}`` / ``proj`` /
    ``fuse`` are ``Aggregate.conv_{1,2,3}`` / ``conv_4`` / ``conv_5``, the
    non-local Dense layers 1x1 convs, ``fc_out`` is ``fc3``."""
    params = variables["params"]
    agg = params["aggregate"]
    sd: Dict[str, torch.Tensor] = {}
    for official, ours in (("conv_1", "dilated1"), ("conv_2", "dilated2"),
                           ("conv_3", "dilated4"), ("conv_5", "fuse")):
        sd[f"Aggregate.{official}.0.weight"] = _conv1d(agg[ours]["kernel"])
        sd[f"Aggregate.{official}.0.bias"] = _t(agg[ours]["bias"])
    sd["Aggregate.conv_4.0.weight"] = _conv1d(agg["proj"]["kernel"])
    nl = agg["non_local"]
    for name, key in (("theta", "theta"), ("phi", "phi"), ("g", "g"), ("out", "W.0")):
        sd[f"Aggregate.non_local.{key}.weight"] = _t(np.asarray(nl[name]["kernel"]).T[:, :, None])
        sd[f"Aggregate.non_local.{key}.bias"] = _t(nl[name]["bias"])
    for official, ours in (("fc1", "fc1"), ("fc2", "fc2"), ("fc3", "fc_out")):
        sd[f"{official}.weight"] = _t(np.asarray(params[ours]["kernel"]).T)
        sd[f"{official}.bias"] = _t(params[ours]["bias"])
    return sd


def sultani_state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Sultani variables -> ``fc{1,2,3}`` Linear names (the JAX package's
    ``export_sultani_state_dict``)."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for name in ("fc1", "fc2", "fc3"):
        sd[f"{name}.weight"] = _t(np.asarray(params[name]["kernel"]).T)
        sd[f"{name}.bias"] = _t(params[name]["bias"])
    return sd


_MGFN_CHAN_LN = {"g": "g", "b": "b"}
_MGFN_BN = {"weight": ("params", "scale"), "bias": ("params", "bias"),
            "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}
_MGFN_CONVS = {"conv", "scc", "attention.to_qkv", "attention.to_v", "attention.rel_pos",
               "attention.to_out", "ffn.in_conv", "ffn.out_conv"}
_MGFN_LNS = {"layer_norm": "norm", "attention.norm": "attention/norm", "ffn.layer_norm": "ffn/norm"}
_MGFN_BLOCK = re.compile(r"^backbone\.layers\.(\d+)\.(\d+)\.(.+)\.([a-z_]+)$")


def _kernel1d(w: np.ndarray) -> np.ndarray:
    """torch Conv1d (O, I, K) -> flax (K, I, O)."""
    return np.transpose(w, (2, 1, 0))


def _kernel_leaf(path: Tuple[str, ...], tensor: str, array: np.ndarray, kernel: Callable):
    """A conv or linear ``weight`` as ``path/kernel`` (through ``kernel``),
    its ``bias`` as ``path/bias``."""
    if tensor == "weight":
        return "params", path + ("kernel",), kernel(array)
    if tensor == "bias":
        return "params", path + ("bias",), array
    return None


def _mgfn_leaf(key: str, array: np.ndarray):
    m = re.match(r"^backbone\.amplifier\.(to_tokens|to_mag)\.([a-z]+)$", key)
    if m:
        return _kernel_leaf(("backbone", "amplifier", m.group(1)), m.group(2), array, _kernel1d)
    if key in ("layer_norm.weight", "layer_norm.bias"):
        return "params", ("head_norm", "scale" if key.endswith("weight") else "bias"), array
    if key in ("fc.weight", "fc.bias"):
        return _kernel_leaf(("fc",), key[3:], array, np.transpose)
    m = _MGFN_BLOCK.match(key)
    if m is None:
        return None
    base = ("backbone", f"stage{m.group(1)}_block{m.group(2)}")
    module, tensor = m.group(3), m.group(4)
    if module in _MGFN_CONVS:
        return _kernel_leaf(base + tuple(module.split(".")), tensor, array, _kernel1d)
    if module in _MGFN_LNS and tensor in _MGFN_CHAN_LN:  # channel LayerNorm, (1, dim, 1)
        return "params", base + tuple(_MGFN_LNS[module].split("/")) + (tensor,), array.reshape(-1)
    if module == "attention.norm":  # a focus block's BatchNorm1d
        if tensor == "num_batches_tracked":
            return SKIP
        if tensor in _MGFN_BN:
            collection, leaf = _MGFN_BN[tensor]
            return collection, base + ("attention", "norm", leaf), array
    return None


def mgfn_state_dict_to_flax(state_dict: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """The port's (the reference's HF-style) MGFN state dict -> flax
    variables, the exact inverse of ``mgfn_state_dict_from_flax`` (the
    layout of the JAX package's ``convert_mgfn_state_dict``): Conv1d
    weights (O, I, K) -> kernels (K, I, O), channel LayerNorms' ``g``/``b``
    (1, dim, 1) -> (dim,), a focus block's BatchNorm1d -> ``scale``/``bias``
    and ``batch_stats`` ``mean``/``var`` (its ``num_batches_tracked``
    dropped), ``layer_norm`` -> ``head_norm``, ``fc`` transposed. Any other
    key raises KeyError naming it. ``batch_stats`` only when a focus block
    has one."""
    return _flax_variables(state_dict, _mgfn_leaf, "MGFN", "raise")


_RTFM_CONVS = {"conv_1": "dilated1", "conv_2": "dilated2", "conv_3": "dilated4", "conv_5": "fuse",
               "conv_4": "proj"}
_RTFM_HEADS = {"fc1": "fc1", "fc2": "fc2", "fc3": "fc_out"}


def _rtfm_leaf(key: str, array: np.ndarray):
    m = re.match(r"^Aggregate\.(conv_[1-5])\.0\.(weight|bias)$", key)
    if m and not (m.group(1) == "conv_4" and m.group(2) == "bias"):
        return _kernel_leaf(("aggregate", _RTFM_CONVS[m.group(1)]), m.group(2), array,
                            _kernel1d)
    m = re.match(r"^Aggregate\.non_local\.(theta|phi|g|W\.0)\.(weight|bias)$", key)
    if m:  # 1x1 Conv1d (O, I, 1) -> Dense (I, O)
        name = "out" if m.group(1) == "W.0" else m.group(1)
        return _kernel_leaf(("aggregate", "non_local", name), m.group(2), array,
                            lambda w: w[:, :, 0].T)
    m = re.match(r"^(fc[123])\.(weight|bias)$", key)
    if m:
        return _kernel_leaf((_RTFM_HEADS[m.group(1)],), m.group(2), array, np.transpose)
    return None


def rtfm_state_dict_to_flax(state_dict: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """The port's RTFM state dict (the official release's names, BN-free)
    -> flax ``{"params"}``, the exact inverse of ``rtfm_state_dict_from_flax``
    (the layout of the JAX package's ``convert_rtfm_state_dict``):
    ``Aggregate.conv_{1,2,3,5}`` / ``conv_4`` are ``dilated{1,2,4}`` /
    ``fuse`` / ``proj``, the non-local 1x1 convs Dense layers (``W.0`` is
    ``out``), ``fc3`` is ``fc_out``. An official checkpoint with BatchNorm
    goes through ``rtfm_state_dict_from_official`` first, which folds it.
    Any other key raises KeyError naming it."""
    return _flax_variables(state_dict, _rtfm_leaf, "RTFM", "raise")


def _sultani_leaf(key: str, array: np.ndarray):
    m = re.match(r"^(fc[123])\.(weight|bias)$", key)
    return _kernel_leaf((m.group(1),), m.group(2), array, np.transpose) if m else None


def sultani_state_dict_to_flax(state_dict: Mapping[str, Any], unknown: str = "raise"
                               ) -> Dict[str, Dict[str, Any]]:
    """The port's Sultani state dict -> flax ``{"params"}``, the exact
    inverse of ``sultani_state_dict_from_flax`` (the JAX package's
    ``convert_sultani_state_dict``): ``fc{1,2,3}`` Linear weights
    transposed to Dense kernels. Any other key raises KeyError naming it
    (``unknown="ignore"``: dropped, named on stderr)."""
    return _flax_variables(state_dict, _sultani_leaf, "Sultani", unknown)


# ---------------------------------------------------------------------------
# The reference's own layouts -> the port's names (``infer --torch-weights``)
# ---------------------------------------------------------------------------


def load_known_keys(model: nn.Module, state_dict: Mapping[str, Any], what: str,
                    refuse: Optional[Callable[[str], bool]] = None) -> None:
    """Load ``state_dict`` into ``model`` as the JAX converters read a
    weight file: they read the keys of their model and ignore the rest (an
    I3D file's Kinetics head ``fc.*``, as the reference's own
    ``strict=False`` load does). So keys the model does not have are
    dropped, with one line on stderr that names them, unless ``refuse``
    says the JAX converter raises on that key; a key the model has and the
    file lacks raises KeyError, as there. BatchNorm's
    ``num_batches_tracked`` is not required: no converter reads it."""
    own = model.state_dict()
    missing = [k for k in own if k not in state_dict and not k.endswith(".num_batches_tracked")]
    if missing:
        raise KeyError(f"{what}: missing key(s) {', '.join(missing)}")
    extra = [k for k in state_dict if k not in own]
    refused = [k for k in extra if refuse is not None and refuse(k)]
    if refused:
        raise KeyError(f"{what}: unrecognized key(s) {', '.join(refused)}")
    if extra:
        print(f"{what}: ignoring {len(extra)} key(s) the model does not have: "
              f"{', '.join(extra)}", file=sys.stderr)
    model.load_state_dict({k: v for k, v in state_dict.items() if k in own}, strict=False)


MGFN_BLOCK_MODULES = ("layer_norm", "conv", "scc", "ffn", "attention")


def mgfn_key_refused(key: str) -> bool:
    """Whether the JAX package's ``convert_mgfn_state_dict`` raises on an
    HF-named MGFN key: one outside ``backbone.amplifier``,
    ``backbone.layers`` (with a block module it knows), ``layer_norm`` and
    ``fc``. It ignores the rest (a Focus BatchNorm's
    ``num_batches_tracked``)."""
    parts = key.split(".")
    if parts[0] == "backbone" and len(parts) > 1:
        parts = parts[1:]
        if parts[0] == "amplifier":
            return False
        if parts[0] == "layers":
            return len(parts) < 4 or parts[3] not in MGFN_BLOCK_MODULES
    return parts[0] not in ("layer_norm", "fc")


def mgfn_state_dict_from_official(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """The official MGFN release's keys -> the HF names the port's MGFN
    loads, the remap of the JAX package's
    ``convert_official_mgfn_state_dict`` (the reference's
    scripts/convert_official_to_hf.py): ``to_tokens`` / ``to_mag`` go under
    ``backbone.amplifier``, ``to_logits`` becomes ``layer_norm``,
    ``stages.{s}.0...`` blocks and ``stages.{s}.1`` intermediates become
    ``backbone.layers.{s}...``. As there, an intermediate lands at block
    index 3 (the reference depths), and keys of no known part (dropouts'
    positions of the feed-forward) are dropped. Tensors pass unchanged."""
    remapped: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        if "to_tokens" in key or "to_mag" in key:
            remapped["backbone.amplifier." + key] = tensor
        elif "to_logits" in key:
            remapped["layer_norm." + key.split(".")[-1]] = tensor
        elif key.startswith("fc"):
            remapped[key] = tensor
        elif key.startswith("stages"):
            info = key.split(".")[1:]
            prefix = f"backbone.layers.{info[0]}."
            if info[1] == "1":  # intermediate
                layer_name = "layer_norm" if info[2] == "0" else "conv"
                remapped[prefix + f"3.{layer_name}.{info[-1]}"] = tensor
            else:  # blocks
                prefix += f"{info[3]}."
                if info[4] == "0":
                    remapped[prefix + f"scc.{info[-1]}"] = tensor
                elif info[4] == "1":
                    remapped[prefix + f"attention.{info[-2]}.{info[-1]}"] = tensor
                elif info[4] == "2":
                    ffn_names = {"0": "layer_norm", "1": "in_conv", "4": "out_conv"}
                    if info[-2] in ffn_names:
                        remapped[prefix + f"ffn.{ffn_names[info[-2]]}.{info[-1]}"] = tensor
    return remapped


def _conv1d_fold_bn(state_dict: Mapping[str, Any], prefix: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """``<prefix>.0`` Conv1d weight and bias (None when absent), with a
    ``<prefix>.1`` eval-mode BatchNorm folded in, in the tensors' own
    dtype: ``w * gamma / sqrt(var + eps)`` per out-channel, ``(b - mean) *
    gamma / sqrt(var + eps) + beta`` (the JAX package's
    ``_conv1d_fold_bn``). A BN after the ReLU (index 2) cannot fold and
    raises ValueError."""

    def get(key):
        return _array(state_dict[f"{prefix}.{key}"])

    w = get("0.weight")
    b = get("0.bias") if f"{prefix}.0.bias" in state_dict else None
    if f"{prefix}.2.running_mean" in state_dict:
        raise ValueError(f"{prefix}: BatchNorm after ReLU cannot be folded into the conv; "
                         "this layout needs an explicit BN in the RTFM module")
    if f"{prefix}.1.running_mean" in state_dict:
        mean, var = get("1.running_mean"), get("1.running_var")
        gamma, beta = get("1.weight"), get("1.bias")
        scale = gamma / np.sqrt(var + 1e-5)
        w = w * scale[:, None, None]
        b = beta + (b - mean) * scale if b is not None else beta - mean * scale
    return w, b


def rtfm_state_dict_from_official(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An official-release RTFM state dict -> the port's RTFM names (the
    JAX package's ``convert_rtfm_state_dict``). A branch whose Sequential
    holds an eval-mode BatchNorm right after its conv (index 1, as the
    official ``non_local.W`` does) folds exactly into the BN-free conv;
    a BN after the ReLU raises ValueError, as does a fold that gives the
    bias-free ``conv_4`` a nonzero bias (its shift would feed attention
    and could not be dropped). ``non_local.W`` without a bias gets zeros."""
    agg = "Aggregate"
    sd: Dict[str, torch.Tensor] = {}
    for name in ("conv_1", "conv_2", "conv_3", "conv_4", "conv_5", "non_local.W"):
        prefix = f"{agg}.{name}"
        w, b = _conv1d_fold_bn(state_dict, prefix)
        if name == "conv_4" and b is not None:
            if np.any(b != 0):
                raise ValueError(f"{prefix}: folding produced a nonzero bias but the target "
                                 "module is bias-free; this BN-after-conv_4 layout is not "
                                 "representable (official checkpoints keep conv_4 bias-free "
                                 "with no BN)")
            b = None
        if name == "non_local.W" and b is None:
            b = np.zeros(w.shape[0], w.dtype)
        sd[f"{prefix}.0.weight"] = _t(w)
        if b is not None:
            sd[f"{prefix}.0.bias"] = _t(b)
    for module in (f"{agg}.non_local.theta", f"{agg}.non_local.phi", f"{agg}.non_local.g",
                   "fc1", "fc2", "fc3"):
        for kind in ("weight", "bias"):
            sd[f"{module}.{kind}"] = _t(_array(state_dict[f"{module}.{kind}"]))
    return sd


# --------------------------------------------- orbax train states -> the port

SCORERS_FROM_FLAX = {"mgfn": mgfn_state_dict_from_flax, "rtfm": rtfm_state_dict_from_flax,
                     "sultani": sultani_state_dict_from_flax}


def adam_state_dict_from_optax(opt_state: Any, batch_stats: Mapping, model_name: str,
                               model: nn.Module, param_groups: list) -> Dict[str, Any]:
    """The JAX package's ``adam_with_l2`` state (an optax chain of three
    slots: clip or identity, add_decayed_weights or identity, adam; slot
    2's ``ScaleByAdamState`` holds ``count``, ``mu`` and ``nu``) as
    ``AdamWithL2.state_dict()`` for ``model``'s parameters, in the order
    the optimizer was given them (``model.parameters()``), with
    ``param_groups`` (the live optimizer's).

    ``mu`` and ``nu`` are trees shaped like the params, so the family's
    ``*_state_dict_from_flax`` relayouts them one to one (pure transposes
    and reshapes; a BatchNorm's ``scale`` / ``bias`` moments become
    ``weight`` / ``bias``). ``count`` becomes each parameter's ``step``:
    optax corrects the bias with ``count + 1`` and torch increments
    ``step`` before it corrects, so the next update agrees."""
    adam = opt_state[2][0]
    if not isinstance(adam, Mapping) or not {"count", "mu", "nu"} <= set(adam):
        raise ValueError("the optimizer state's slot 2 is not an optax ScaleByAdamState "
                         "(count, mu, nu); only adam_with_l2 states are converted")
    convert = SCORERS_FROM_FLAX[model_name]
    mu = convert({"params": adam["mu"], "batch_stats": batch_stats})
    nu = convert({"params": adam["nu"], "batch_stats": batch_stats})
    step = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    state = {}
    for i, (name, _) in enumerate(model.named_parameters()):
        if name not in mu or name not in nu:
            raise ValueError(f"the optimizer state has no moments for parameter {name!r}")
        state[i] = {"step": step.clone(), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
    return {"state": state, "param_groups": param_groups}


# --------------------------------------------- the port's train states -> orbax

SCORERS_TO_FLAX = {"mgfn": mgfn_state_dict_to_flax, "rtfm": rtfm_state_dict_to_flax,
                   "sultani": sultani_state_dict_to_flax}


def adam_state_dict_to_optax(optimizer_sd: Mapping[str, Any], model_sd: Mapping[str, Any],
                             model_name: str, param_names: list) -> list:
    """``AdamWithL2.state_dict()`` -> the JAX package's ``adam_with_l2``
    state, the inverse of ``adam_state_dict_from_optax``: the chain's three
    slots ``[EmptyState, EmptyState, (ScaleByAdamState, EmptyState)]``,
    each empty state None and the ``ScaleByAdamState`` a dict ``count``,
    ``mu``, ``nu``. ``param_names`` name the optimizer's parameters in
    the order it was given them (``model.named_parameters()``).

    ``mu`` and ``nu`` are each parameter's ``exp_avg`` / ``exp_avg_sq``
    through the family's ``*_state_dict_to_flax``; ``count`` is the
    parameters' common ``step`` as an int32 scalar. An optimizer that has
    not stepped yet gives zero moments and count 0 (what a fresh optax
    state holds); parameters whose steps differ, or of which only some
    have a state, raise ValueError."""
    ids = [i for group in optimizer_sd["param_groups"] for i in group["params"]]
    if len(ids) != len(param_names):
        raise ValueError(f"the optimizer holds {len(ids)} parameters, the model "
                         f"{len(param_names)}")
    state = optimizer_sd["state"]
    if not state:
        zeros = {n: torch.zeros_like(torch.as_tensor(model_sd[n])) for n in param_names}
        mu, nu, count = zeros, zeros, 0
    else:
        missing = [n for i, n in zip(ids, param_names) if i not in state]
        if missing or any(not {"step", "exp_avg", "exp_avg_sq"} <= set(state[i]) for i in ids):
            raise ValueError("only Adam states of every parameter convert to optax; no "
                             f"moments for {missing or 'some parameters'}")
        steps = {float(state[i]["step"]) for i in ids}
        if len(steps) != 1:
            raise ValueError(f"the parameters' Adam steps differ ({sorted(steps)}); optax "
                             "keeps one count")
        count = steps.pop()
        mu = {n: state[i]["exp_avg"] for i, n in zip(ids, param_names)}
        nu = {n: state[i]["exp_avg_sq"] for i, n in zip(ids, param_names)}
    convert = SCORERS_TO_FLAX[model_name]
    adam = {"count": np.asarray(count, np.int32), "mu": convert(mu)["params"],
            "nu": convert(nu)["params"]}
    return [None, None, [adam, None]]


def train_state_to_orbax(state: Any, model_name: str,
                         state_dicts: Optional[Tuple[dict, dict]] = None) -> Dict[str, Any]:
    """The port's ``TrainState`` of family ``model_name`` as the tree the
    JAX package's checkpointer saves, the inverse of
    ``train_state_from_orbax``: ``params`` and ``batch_stats`` (``{}`` for
    a family without BatchNorm; a BatchNorm's ``num_batches_tracked`` has
    no counterpart) through ``*_state_dict_to_flax``, ``opt_state``
    through ``adam_state_dict_to_optax``, ``step`` an int32 scalar; numpy
    arrays in the state's own dtypes. ``state_dicts`` are the state's
    ``state_dicts()`` where the caller has them (a DP x TP state gathers
    them collectively)."""
    if model_name not in SCORERS_TO_FLAX:
        raise ValueError(f"unknown model {model_name!r}; orbax steps convert for "
                         f"{sorted(SCORERS_TO_FLAX)}")
    model_sd, optimizer_sd = state_dicts or state.state_dicts()
    variables = SCORERS_TO_FLAX[model_name](model_sd)
    names = [n for n, _ in state.model.named_parameters()]
    return {"params": variables["params"], "batch_stats": variables.get("batch_stats", {}),
            "opt_state": adam_state_dict_to_optax(optimizer_sd, model_sd, model_name, names),
            "step": np.asarray(int(state.step), np.int32)}


def _float32_leaves(tree: Any) -> Any:
    """``tree`` with its bfloat16 leaves (torch tensors: numpy has no
    bfloat16) as float32 numpy arrays, exactly, as orbax restores a
    bfloat16 array into a float32 template."""
    if isinstance(tree, Mapping):
        return {k: _float32_leaves(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_float32_leaves(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def train_state_from_orbax(tree: Mapping[str, Any], model_name: str, state: Any) -> Any:
    """Load a JAX train state read from an orbax step
    (``training/orbax.read_orbax_step``: params, batch_stats, opt_state,
    step) into the port's ``TrainState`` ``state`` of family
    ``model_name``: the weights through ``*_state_dict_from_flax``, the
    Adam moments through ``adam_state_dict_from_optax``, and the step.
    A tree that does not fit the model raises (RuntimeError, ValueError
    or KeyError). bfloat16 leaves load as float32, as orbax restores them
    into the JAX runner's float32 template."""
    if model_name not in SCORERS_FROM_FLAX:
        raise ValueError(f"unknown model {model_name!r}; orbax steps convert for "
                         f"{sorted(SCORERS_FROM_FLAX)}")
    tree = _float32_leaves(tree)
    batch_stats = tree.get("batch_stats") or {}
    model_sd = SCORERS_FROM_FLAX[model_name]({"params": tree["params"],
                                              "batch_stats": batch_stats})
    optimizer_sd = adam_state_dict_from_optax(
        tree["opt_state"], batch_stats, model_name, state.model,
        state.optimizer.state_dict()["param_groups"])
    state.load_state_dicts(model_sd, optimizer_sd)
    state.step = int(np.asarray(tree["step"]))
    return state
