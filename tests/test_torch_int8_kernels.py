"""PyTorch port vs the JAX package: int8 kernels.

The int8 ConvBN of every conv geometry of the i3res50 int8 path, the plain
versions of kernels K4 (int8 matrix product) and K5 (int8 conv) against
the Pallas kernel and the dot_general they replace, the packed operands'
reuse, and the wrappers' input checks and launch counts.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anomaly_detection_on_video_tpu.models import i3d as ji3d
from anomaly_detection_on_video_tpu_torch.models import i3d as ti3d
from anomaly_detection_on_video_tpu_torch.ops import kernels
from anomaly_detection_on_video_tpu_torch.ops.kernels import (
    int8_conv,
    int8_conv_plain,
    int8_matmul,
    int8_matmul_plain,
)
from test_torch_i3d import _randomize_bn
from torch_int8_fixtures import GEOMETRIES, _port_conv_bn
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as in tests/test_torch_train.py: torch's default
    pool contends with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


@pytest.mark.parametrize("use_bn", [False, True], ids=["no_bn", "bn"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_int8_conv_bn_matches_jax(rng, geometry, use_bn):
    """The port's int8 ConvBN (K4 / K5 plain on the CPU) against a top-level
    flax ConvBN with act_scales {"": s}: bit-equal without BN."""
    cin, kernel, stride, padding = GEOMETRIES[geometry]
    cout = 8
    x = (rng.randn(2, 6, 9, 11, cin) * 1.5).astype(np.float32)
    act_scale = float(np.abs(x).max()) / 127.0 * 0.8  # the top values saturate
    m = ji3d.ConvBN(cout, kernel=kernel, strides=stride, padding=padding, use_bn=use_bn,
                    dtype=jnp.float32, act_scales={"": act_scale})
    variables = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    if use_bn:
        variables = _randomize_bn(variables, rng)
    ref = np.asarray(m.apply(variables, jnp.asarray(x)))

    conv, bn = _port_conv_bn(variables, cin, cout, kernel, stride, padding, use_bn)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)  # NCDHW view, channels-last strides
    with torch.no_grad():
        if use_bn:
            got = ti3d.conv_bn(xt, conv, bn, act_scale)
        else:
            got = ti3d.int8_conv_nd(xt, conv, act_scale)
    got = got.permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == ref.shape
    if use_bn:
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("out_int8", [True, False], ids=["int8_out", "bf16_out"])
def test_int8_conv_plain_matches_pallas_kernel(rng, monkeypatch, out_int8):
    """K5's plain version against the Pallas kernel itself (interpret mode)
    at two (128, 28x28) planes, bit-equal in both epilogues. Pallas rows of
    w are ``tap * C + c_in`` with taps (kh, kw) row-major: K5's (Cout, K)
    operand is its transpose."""
    sys.path.insert(0, SCRIPTS)
    try:
        import int8_pallas_probe as probe
    finally:
        sys.path.remove(SCRIPTS)
    monkeypatch.setattr(probe, "B", 2)
    monkeypatch.setattr(probe, "T", 1)
    c, side = probe.PLANES, probe.H
    x = rng.randint(-8, 9, (2, c, side * side)).astype(np.int8)
    w = rng.randint(-3, 4, (9 * c, c)).astype(np.int8)
    # half the channels at 0.5 put exact halves in the product: round half to even
    s = np.where(np.arange(c) % 2 == 0, 0.5, rng.uniform(0.01, 0.3, c)).astype(np.float32)
    ref = probe.make_conv3x3(out_int8=out_int8, interpret=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s[:, None]))
    ref = np.asarray(ref).astype(np.float32)  # (2, C, F)

    x_cl = torch.from_numpy(x.reshape(2, c, side, side).transpose(0, 2, 3, 1).copy())[:, None]
    out_dtype = torch.int8 if out_int8 else torch.bfloat16
    got = int8_conv(x_cl, torch.from_numpy(w.T.copy()), torch.from_numpy(s), (1, 3, 3), (1, 1, 1),
                    (0, 1, 1), out_dtype)
    assert got.dtype == out_dtype and got.shape == (2, 1, side, side, c)
    got = got[:, 0].float().numpy().reshape(2, side * side, c).transpose(0, 2, 1)
    if out_int8:
        assert (np.abs(ref) == 127).any() and (np.abs(ref) < 127).mean() > 0.5
    np.testing.assert_array_equal(got, ref)


def test_int8_matmul_plain_matches_dot_general(rng):
    """K4's plain version against the body of ``probe_raw_matmul``:
    dot_general(w (K, N), x (K, M)) contracting dim 0 into int32."""
    k, n, m = 96, 40, 72
    x = rng.randint(-127, 128, (k, m)).astype(np.int8)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    ref = np.asarray(jax.lax.dot_general(
        jnp.asarray(w), jnp.asarray(x), (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))  # (N, M)
    w_nk = torch.from_numpy(w.T.copy())  # K4's (N, K) operand
    got = int8_matmul(torch.from_numpy(x.T.copy()), w_nk)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().T, ref)
    scale = torch.from_numpy(rng.uniform(1e-5, 1e-3, n).astype(np.float32))
    scaled = int8_matmul(torch.from_numpy(x.T.copy()), w_nk, scale, torch.bfloat16)
    np.testing.assert_array_equal(scaled.float().numpy(),
                                  (got.float() * scale).to(torch.bfloat16).float().numpy())


def test_int8_operands_repacked_for_a_new_scale(rng):
    """A conv keeps one packed int8 operand set: reused while its weight and
    input scale stay, replaced (not added to) when the scale changes."""
    conv = torch.nn.Conv3d(16, 8, (1, 3, 3), padding=(0, 1, 1), bias=False)
    x = torch.from_numpy(rng.randn(1, 2, 5, 5, 16).astype(np.float32)).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        first = ti3d.int8_conv_nd(x, conv, 0.02)
        packed = conv._kernel_operands[("int8", x.device)][1]
        ti3d.int8_conv_nd(x, conv, 0.02)
        assert conv._kernel_operands[("int8", x.device)][1] is packed
        second = ti3d.int8_conv_nd(x, conv, 0.05)
    assert len(conv._kernel_operands) == 1
    assert conv._kernel_operands[("int8", x.device)][1] is not packed
    fresh = torch.nn.Conv3d(16, 8, (1, 3, 3), padding=(0, 1, 1), bias=False)
    fresh.load_state_dict(conv.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(second, ti3d.int8_conv_nd(x, fresh, 0.05), atol=0, rtol=0)
    assert not torch.equal(first, second)


def test_int8_wrappers_check_inputs_and_count_only_launches(rng):
    a = torch.from_numpy(rng.randint(-5, 6, (6, 32)).astype(np.int8))
    b = torch.from_numpy(rng.randint(-5, 6, (16, 32)).astype(np.int8))  # (N, K)
    x = torch.from_numpy(rng.randint(-5, 6, (1, 2, 5, 5, 16)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-5, 6, (8, 9 * 16)).astype(np.int8))  # (Cout, K)
    s16, s8 = torch.ones(16), torch.ones(8)
    before = kernels.launch_counts()
    assert {"int8_matmul", "int8_conv"} <= set(before)
    torch.testing.assert_close(int8_matmul(a, b, s16, torch.float32),
                               int8_matmul_plain(a, b, s16, torch.float32))
    geo = ((1, 3, 3), (1, 1, 1), (0, 1, 1))
    torch.testing.assert_close(int8_conv(x, w, s8, *geo, torch.int8),
                               int8_conv_plain(x, w, s8, *geo, torch.int8))
    assert kernels.launch_counts() == before
    bad_matmul = [
        (a.float(), b, None, None),  # not int8
        (a, b[:, :8], None, None),  # K mismatch
        (a, b, None, torch.float32),  # out_dtype without a scale
        (a, b, s8, torch.float32),  # scale length
        (a, b, s16.double(), torch.float32),  # scale type
        (a, b, s16, torch.int8),  # out_dtype K4 does not write
    ]
    for args in bad_matmul:
        with pytest.raises(ValueError):
            int8_matmul(*args)
    bad_conv = [
        (x.float(), w, s8, *geo, torch.int8),  # not int8
        (x[0], w, s8, *geo, torch.int8),  # not 5-D
        (x, w[:, :-16], s8, *geo, torch.int8),  # weights do not match the kernel
        (x, w, None, *geo, torch.int8),  # no scale
        (x, w, s16, *geo, torch.int8),  # scale length
        (x, w, s8, *geo, torch.int32),  # out_dtype
        (x, w, s8, (1, 3, 3), (1, 0, 1), (0, 1, 1), torch.int8),  # stride 0
        (x, w, s8, (1, 3, 3), (1, 1), (0, 1, 1), torch.int8),  # two strides
    ]
    for args in bad_conv:
        with pytest.raises(ValueError):
            int8_conv(*args)
