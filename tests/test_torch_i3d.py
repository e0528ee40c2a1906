"""PyTorch port vs the JAX package: the i3res50 stem (K2), the stage-1
bottleneck (K3), a narrow I3DResNet and the weight converter.

The kernels' plain versions are held against the JAX functions; the
kernels' packed operand layouts (what the CUDA code indexes) are held
against the plain versions by evaluating them with torch on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from anomaly_detection_on_video_tpu.models import i3d as ji3d
from anomaly_detection_on_video_tpu.utils.convert import export_i3res50_state_dict
from anomaly_detection_on_video_tpu_torch.models import i3d as ti3d
from anomaly_detection_on_video_tpu_torch.ops.kernels import (
    bottleneck_block,
    bottleneck_plain,
    pack_block_params,
    pack_stem_params,
    stem_conv_pool,
    stem_plain,
)
from anomaly_detection_on_video_tpu_torch.ops.kernels._operands import cached_operands
from anomaly_detection_on_video_tpu_torch.ops.kernels.stem import fold_bn
from anomaly_detection_on_video_tpu_torch.utils.convert import i3d_state_dict_from_flax


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as in tests/test_torch_train.py: torch's default
    pool contends with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NARROW = ((8, 1, 1, (3,), (1,)), (16, 1, 2, (1,), (1,)))


def _randomize_bn(variables, rng):
    """Random BN affine and running stats (identity BN hides layout bugs)."""
    def walk(params, stats):
        for key, node in params.items():
            if key == "bn":
                n = node["scale"].shape[0]
                node["scale"] = (rng.rand(n) + 0.5).astype(np.float32)
                node["bias"] = (rng.randn(n) * 0.1).astype(np.float32)
                stats[key]["mean"] = (rng.randn(n) * 0.1).astype(np.float32)
                stats[key]["var"] = (rng.rand(n) + 0.5).astype(np.float32)
            elif isinstance(node, dict) and key in stats:
                walk(node, stats[key])

    variables = jax.tree_util.tree_map(lambda a: np.array(a), variables)
    walk(variables["params"], variables["batch_stats"])
    return variables


def _block_state_dict(variables):
    """A flax Bottleneck's variables -> the port block's state dict."""
    stem_p = {"conv": {"kernel": np.zeros((5, 7, 7, 3, 64), np.float32)},
              "bn": {"scale": np.ones(64, np.float32), "bias": np.zeros(64, np.float32)}}
    stem_s = {"bn": {"mean": np.zeros(64, np.float32), "var": np.ones(64, np.float32)}}
    sd = i3d_state_dict_from_flax({
        "params": {"stem": stem_p, "stage1_block0": variables["params"]},
        "batch_stats": {"stem": stem_s, "stage1_block0": variables["batch_stats"]},
    })
    prefix = "layer1.0."
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def test_stem_plain_matches_jax_chain(rng):
    """K2's plain version at the kernel's only geometry vs the JAX chain
    (conv + folded BN + ReLU + max pool, as tests/test_pallas.py builds it)."""
    import flax.linen as nn

    x = rng.randn(1, 16, 224, 224, 3).astype(np.float32)
    kern = (rng.randn(5, 7, 7, 3, 64) * 0.05).astype(np.float32)
    gamma = (rng.rand(64) + 0.5).astype(np.float32)
    beta = (rng.randn(64) * 0.1).astype(np.float32)
    mean = (rng.randn(64) * 0.1).astype(np.float32)
    var = (rng.rand(64) + 0.5).astype(np.float32)

    y = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(kern), (2, 2, 2), [(2, 2), (3, 3), (3, 3)],
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    g = gamma / np.sqrt(var + 1e-5)
    y = jnp.maximum(y * g + (beta - mean * g), 0)
    ref = np.asarray(nn.max_pool(y, (2, 3, 3), strides=(2, 2, 2), padding=[(0, 0)] * 3))

    conv = torch.nn.Conv3d(3, 64, (5, 7, 7), bias=False)
    bn = torch.nn.BatchNorm3d(64)
    with torch.no_grad():
        for tensor, value in ((conv.weight, kern.transpose(4, 3, 0, 1, 2)), (bn.weight, gamma),
                              (bn.bias, beta), (bn.running_mean, mean), (bn.running_var, var)):
            tensor.copy_(torch.from_numpy(np.ascontiguousarray(value)))
        got = stem_conv_pool(torch.from_numpy(x), conv, bn).numpy()
    assert got.shape == (1, 4, 55, 55, 64)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


def stem_slab(x):
    """The stem kernels' per-pixel vectors (csrc/stem.cu, csrc/int8_conv.cu)
    for a whole plane: (B, T, H, W, C) -> (B, To, H+6, 2, Q, 16), input rows
    from -3 and columns from -4 split by parity (column 2*i + parity), each
    vector ``[kt * C + c]`` of stem frame s (input frames 2s-2 .. 2s+2),
    zeros after its 5C values and in the padding (C = 3, or 2 for flow)."""
    b, t, h, w, c = x.shape
    frames_out, cols = (t + 1) // 2, w + 8 + w % 2
    xp = F.pad(x, (0, 0, 4, cols - w - 4, 3, 3, 2, 2))
    frames = torch.stack([xp[:, 2 * s: 2 * s + 5] for s in range(frames_out)], 1)
    vec = frames.permute(0, 1, 3, 4, 2, 5).reshape(b, frames_out, h + 6, cols, 5 * c)
    vec = F.pad(vec, (0, 16 - 5 * c))
    return vec.reshape(b, frames_out, h + 6, cols // 2, 2, 16).transpose(3, 4)


def stem_tap_rows(slab, kh, kw, ho, wo):
    """The A rows of tap (kh, kw) for every stem position, read as the
    kernels address them: slab row 2*sr + kh, column 2*sc + kw + 1."""
    q = kw + 1
    return slab[:, :, kh: kh + 2 * ho - 1: 2, q % 2, q // 2: q // 2 + wo]


@pytest.mark.parametrize("layout", ["f32_rows", "bf16_slab"])
def test_stem_packed_weights_reproduce_conv(rng, layout):
    """The kernel's operands are the conv it computes. float32: an im2col
    product with the (735, 64) operand, rows (kt, kh, kw, c). bfloat16: the
    tensor-core operand (64, 784) against per-pixel [kt, c] vectors, one
    k16 step per (kh, kw) tap, on bfloat16-valued inputs; both equal
    F.conv3d at 1e-4."""
    w = torch.from_numpy(rng.randn(64, 3, 5, 7, 7).astype(np.float32))
    if layout == "f32_rows":
        x = torch.from_numpy(rng.randn(1, 8, 16, 16, 3).astype(np.float32))
        packed = pack_stem_params(w, torch.float32)
        assert packed.shape == (735, 64)
        xp = F.pad(x, (0, 0, 3, 3, 3, 3, 2, 2))  # (B, T, H, W, C): pad t 2, h/w 3
        patches = xp.unfold(1, 5, 2).unfold(2, 7, 2).unfold(3, 7, 2)  # (B,T',H',W',C,5,7,7)
        patches = patches.permute(0, 1, 2, 3, 5, 6, 7, 4).reshape(*patches.shape[:4], 735)
        got = patches @ packed
    else:
        x = torch.from_numpy(rng.randn(1, 16, 16, 16, 3).astype(np.float32))
        x, w = x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float()
        packed = pack_stem_params(w, torch.bfloat16)
        assert packed.shape == (64, 784) and packed.dtype == torch.bfloat16
        assert packed.is_contiguous()
        taps = packed.float().reshape(64, 49, 16)
        assert not taps[:, :, 15].any()
        slab = stem_slab(x)
        assert slab.shape == (1, 8, 22, 2, 12, 16)
        got = sum(stem_tap_rows(slab, kh, kw, 8, 8) @ taps[:, kh * 7 + kw].t()
                  for kh in range(7) for kw in range(7))
    ref = F.conv3d(x.permute(0, 4, 1, 2, 3), w, None, 2, (2, 3, 3)).permute(0, 2, 3, 4, 1)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("cin,tk,has_proj", [(16, 3, True), (16, 1, True), (16, 3, False)])
def test_bottleneck_plain_matches_jax_module(rng, cin, tk, has_proj):
    """K3's plain version vs the JAX Bottleneck (tests/test_pallas.py's setup)."""
    planes = 4
    if not has_proj:
        cin = planes * 4
    m = ji3d.Bottleneck(planes=planes, temp_kernel=tk, has_proj=has_proj, dtype=jnp.float32)
    x = rng.randn(1, 2, 55, 55, cin).astype(np.float32)
    vs = _randomize_bn(m.init(jax.random.PRNGKey(1), jnp.asarray(x)), rng)
    ref = np.asarray(m.apply(vs, jnp.asarray(x)))

    block = ti3d.Bottleneck(cin, planes, temp_kernel=tk, has_proj=has_proj)
    block.load_state_dict(_block_state_dict(vs))
    with torch.no_grad():
        got = bottleneck_block(torch.from_numpy(x), block).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


def _packed_block(x, ops):
    """The kernel's arithmetic on its packed operands, in torch float32:
    x (B, T, H, W, Cin) -> (B, T, H, W, 4P). bfloat16 operands are (out, in)
    matrices and are read through their transposes."""
    if ops["wa"].dtype == torch.bfloat16:
        ops = {k: v.float().transpose(-1, -2) if k.startswith("w") else v for k, v in ops.items()}
    t = x.shape[1]
    xt = F.pad(x, (0, 0, 0, 0, 0, 0, 1, 1))  # temporal zero padding
    ya = sum(xt[:, dt: dt + t] @ ops["wa"][dt] for dt in range(3))
    ya = torch.relu(ya * ops["sa"] + ops["ba"])
    planes = ya.shape[-1]
    yp = F.pad(ya, (0, 0, 1, 1, 1, 1))  # spatial zero padding
    h, w = x.shape[2:4]
    wb = ops["wb"].reshape(3, 3, planes, planes)
    yb = sum(yp[:, :, kh: kh + h, kw: kw + w] @ wb[kh, kw] for kh in range(3) for kw in range(3))
    yb = torch.relu(yb * ops["sb"] + ops["bb"])
    z = (yb @ ops["wc"]) * ops["sc"] + ops["bc"]
    r = (x @ ops["wp"]) * ops["sp"] + ops["bp"] if "wp" in ops else x
    return torch.relu(z + r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("tk,has_proj", [(3, True), (1, True), (3, False)])
def test_bottleneck_packed_operands_reproduce_block(rng, tk, has_proj, dtype):
    """The float32 (in, out) and the bfloat16 (out, in) operand sets are the
    block: evaluated in float32 they reproduce the plain block (whose conv
    weights hold bfloat16 values in the bf16 case)."""
    planes = 8
    cin = 16 if has_proj else 4 * planes
    block = ti3d.Bottleneck(cin, planes, temp_kernel=tk, has_proj=has_proj)
    with torch.no_grad():
        for name, p in block.named_parameters():
            w = torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.3)
            p.copy_(w.to(dtype).float() if p.dim() == 5 else w)
        for name, buf in block.named_buffers():
            if "running_var" in name:
                buf.copy_(torch.from_numpy(rng.rand(*buf.shape).astype(np.float32) + 0.5))
            elif "running_mean" in name:
                buf.copy_(torch.from_numpy(rng.randn(*buf.shape).astype(np.float32) * 0.1))
    x = torch.from_numpy(rng.randn(2, 4, 9, 7, cin).astype(np.float32))
    ops = pack_block_params(block, dtype)
    if dtype == torch.bfloat16:
        assert ops["wa"].shape == (3, planes, cin) and ops["wb"].shape == (planes, 9 * planes)
        assert ops["wc"].shape == (4 * planes, planes) and ops["sa"].dtype == torch.float32
        assert all(v.dtype == dtype and v.is_contiguous() for k, v in ops.items() if k[0] == "w")
    else:
        assert ops["wa"].shape == (3, cin, planes) and ops["wb"].shape == (9 * planes, planes)
    with torch.no_grad():
        torch.testing.assert_close(_packed_block(x, ops), bottleneck_plain(x, block),
                                   atol=1e-4, rtol=1e-5)


def _narrow_variables(rng):
    model = ji3d.I3DResNet(stages=NARROW, dtype=jnp.float32)
    x = rng.randn(1, 16, 224, 224, 3).astype(np.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    return model, _randomize_bn(variables, rng), x


def test_narrow_i3d_matches_jax(rng):
    """flax init -> port converter -> load_state_dict -> same features."""
    model, variables, x = _narrow_variables(rng)
    ref = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))

    port = ti3d.I3DResNet(stages=NARROW)
    port.load_state_dict(i3d_state_dict_from_flax(variables))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_i3res50_converter_equals_export(rng):
    """Port converter == JAX exporter, key by key, bit by bit."""
    _, variables, _ = _narrow_variables(rng)
    ref = export_i3res50_state_dict(variables)
    got = i3d_state_dict_from_flax(variables)
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        assert got[key].dtype == torch.from_numpy(np.asarray(value)).dtype, key
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    # and the full-width module takes the reference names
    full = ti3d.build_i3d_feature_extractor("tushar-n-baseline")
    names = set(full.state_dict())
    assert {"conv1.weight", "bn1.running_var", "layer1.0.downsample.0.weight",
            "layer4.2.bn3.weight"} <= names
    assert sum(k.endswith(".weight") and "conv" in k for k in names) == 1 + 3 * 16


def test_kernel_wrappers_check_inputs_and_count_only_launches(rng):
    block = ti3d.Bottleneck(64, 64, has_proj=True)
    x = torch.from_numpy(rng.randn(1, 4, 9, 9, 64).astype(np.float32))
    counts = (stem_conv_pool.launches, bottleneck_block.launches)
    torch.testing.assert_close(bottleneck_block(x, block), bottleneck_plain(x, block))
    assert (stem_conv_pool.launches, bottleneck_block.launches) == counts
    conv, bn = torch.nn.Conv3d(3, 64, (5, 7, 7), bias=False), torch.nn.BatchNorm3d(64)
    with pytest.raises(ValueError):
        stem_conv_pool(torch.zeros(1, 16, 32, 32, 3, dtype=torch.float16), conv, bn)
    with pytest.raises(ValueError):
        stem_conv_pool(torch.zeros(1, 16, 32, 32, 4), conv, bn)
    with pytest.raises(ValueError):
        bottleneck_block(x.half(), block)
    w, ones, zeros = torch.zeros(64, 3, 5, 7, 7), torch.ones(64), torch.zeros(64)
    assert stem_plain(torch.zeros(1, 16, 32, 32, 3), w, ones, zeros).shape == (1, 4, 7, 7, 64)


def test_cached_operands_repack_only_when_weights_change(rng):
    """Operands are packed once per (dtype, device) and again after any
    write to a source tensor: load_state_dict, an in-place edit, .to()."""
    block = ti3d.Bottleneck(16, 4, has_proj=True)
    packs = []

    def get(dtype=torch.float32):
        def pack():
            packs.append(dtype)
            return pack_block_params(block, dtype)
        return cached_operands(block, (*block.parameters(), *block.buffers()), dtype, pack)

    first = get()
    assert get() is first and len(packs) == 1
    get(torch.bfloat16)
    assert len(packs) == 2
    state = {k: torch.from_numpy(rng.rand(*v.shape).astype(np.float32) + 0.5) if v.is_floating_point()
             else v for k, v in block.state_dict().items()}
    block.load_state_dict(state)
    after_load = get()
    assert len(packs) == 3
    torch.testing.assert_close(after_load["sc"], fold_bn(block.bn3)[0])
    with torch.no_grad():
        block.bn1.running_var.mul_(2.0)
    torch.testing.assert_close(get()["sa"], fold_bn(block.bn1)[0])
    assert len(packs) == 4
    block.to(torch.float64).to(torch.float32)  # new tensors under the same names
    get()
    assert len(packs) == 5
