"""PyTorch port vs the JAX package: the optical-flow stream's flows.

The host flow (OpenCV Farneback and its uint8 form) bit-equal between the
packages; every function of the device Farneback (``ops/flow.py``) at
atol = rtol = 1e-5; the whole Farneback and TV-L1 flows (``ops/tvl1.py``)
on textured, translated scenes within 1e-3 px with equal uint8 flow, the
translation recovered within the JAX tests' tolerances; and sub-batched
pairs equal to one batch. CPU, float32, one torch thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anomaly_detection_on_video_tpu.data import flow as jdflow
from anomaly_detection_on_video_tpu.ops import flow as jflow
from anomaly_detection_on_video_tpu.ops import tvl1 as jtvl1
from anomaly_detection_on_video_tpu_torch.data import flow as tdflow
from anomaly_detection_on_video_tpu_torch.ops import flow as tflow
from anomaly_detection_on_video_tpu_torch.ops import tvl1 as ttvl1
from test_flow import smooth_image, to_rgb
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker

scipy_ndimage = pytest.importorskip("scipy.ndimage")

SHIFT = (1.3, -0.7)  # (dx, dy) px per frame: sub-pixel, both directions
FLOW_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def textured_scene(n, h, w, shift=SHIFT, seed=0):
    """uint8 RGB (n, h, w, 3): a smooth random texture moving by ``shift``
    px per frame (cubic resampling), channels that differ, so the luma
    weights matter. Noise has no meaningful flow; this has a known one."""
    rng = np.random.RandomState(seed)
    base = scipy_ndimage.gaussian_filter(rng.rand(h + 40, w + 40) * 255, 2.0)
    frames = []
    for i in range(n):
        moved = scipy_ndimage.shift(base, (shift[1] * i, shift[0] * i), order=3, mode="reflect")
        f = np.clip(moved[20:20 + h, 20:20 + w], 0, 255).astype(np.uint8)
        frames.append(np.stack([f, np.roll(f, 3, 1), f // 2 + 60], -1))
    return np.stack(frames)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------ host flow

def test_host_flow_and_uint8_are_bit_equal_to_jax():
    """data/flow.py: OpenCV Farneback (frame 0 zero), its uint8 form and the
    inverse, bit for bit against the JAX package's functions."""
    pytest.importorskip("cv2")
    frames = textured_scene(4, 40, 56)
    got, ref = tdflow.compute_flow(frames), jdflow.compute_flow(frames)
    assert got.dtype == np.float32 and got.shape == (4, 40, 56, 2)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_array_equal(tdflow.flow_to_uint8(got), jdflow.flow_to_uint8(ref))
    q = tdflow.flow_to_uint8(got)
    np.testing.assert_array_equal(tdflow.flow_standardize(q), jdflow.flow_standardize(q))
    np.testing.assert_array_equal(tdflow.flow_standardize(_t(q)).numpy(),
                                  jdflow.flow_standardize(q))
    np.testing.assert_array_equal(tdflow.flow_to_uint8(_t(got)).numpy(), jdflow.flow_to_uint8(ref))
    assert tdflow.FLOW_BOUND == jdflow.FLOW_BOUND == tflow.FLOW_BOUND


# ------------------------------------------------------- Farneback functions

@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("taps", ["poly", "box", "g5"])
def test_conv_axis_matches_jax(rng, axis, taps):
    """Edge-replicated separable correlation, channels kernel-major per
    input channel (three kernels over two channels, and single kernels)."""
    kernels = {"poly": jflow._POLY_K, "box": jflow._BOX, "g5": jflow._G5}[taps]
    x = (rng.rand(2, 13, 17, 2) * 255).astype(np.float32)
    ref = np.asarray(jflow._conv_axis(jnp.asarray(x), kernels, axis))
    got = tflow._conv_axis(_t(x), kernels, axis).numpy()
    assert got.shape == ref.shape == (2, 13, 17, 2 * kernels.shape[0])
    np.testing.assert_allclose(got, ref, **FLOW_TOL)


def test_poly_expansion_and_constants_match_jax():
    img = textured_scene(2, 24, 31)[..., 0].astype(np.float32)
    b_ref, a_ref = jflow.poly_expansion(jnp.asarray(img))
    b, a = tflow.poly_expansion(_t(img))
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), **FLOW_TOL)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), **FLOW_TOL)
    np.testing.assert_array_equal(tflow._POLY_K, jflow._POLY_K)
    np.testing.assert_array_equal(tflow._G_INV, jflow._G_INV)
    for name in ("POLY_N", "POLY_SIGMA", "WINSIZE", "LEVELS", "ITERATIONS", "PYR_SCALE"):
        assert getattr(tflow, name) == getattr(jflow, name), name


def test_bilinear_warp_matches_jax_including_outside_flows(rng):
    """Fractional flows inside the frame and flows that point past every
    border (the clamps), on a 5-channel field."""
    field = rng.randn(2, 11, 14, 5).astype(np.float32)
    flow = (rng.randn(2, 11, 14, 2) * 3).astype(np.float32)
    flow[0, :3] += 40.0  # far right / below
    flow[1, -3:] -= 40.0  # far left / above
    ref = np.asarray(jflow._bilinear_warp(jnp.asarray(field), jnp.asarray(flow)))
    got = tflow._bilinear_warp(_t(field), _t(flow)).numpy()
    np.testing.assert_allclose(got, ref, **FLOW_TOL)


def test_flow_iteration_matches_jax(rng):
    frames = textured_scene(2, 20, 26)[..., 0].astype(np.float32)
    (b1, a1), (b2, a2) = (jflow.poly_expansion(jnp.asarray(frames[i:i + 1])) for i in (0, 1))
    flow = (rng.randn(1, 20, 26, 2) * 0.5).astype(np.float32)
    ref = np.asarray(jflow._flow_iteration(b1, a1, b2, a2, jnp.asarray(flow)))
    args = [_t(np.asarray(v)) for v in (b1, a1, b2, a2)] + [_t(flow)]
    got = tflow._flow_iteration(*args).numpy()
    np.testing.assert_allclose(got, ref, **FLOW_TOL)


@pytest.mark.parametrize("size", [(24, 32), (25, 33)], ids=["even", "odd"])
def test_downsample_and_upsample_match_jax(rng, size):
    """The pyramid: blur + decimation, and the bilinear x2 flow upsample
    (jax.image.resize / PYR_SCALE) back to the finer level, at even and odd
    sizes."""
    img = (rng.rand(2, *size) * 255).astype(np.float32)
    down = np.asarray(jflow._downsample(jnp.asarray(img)))
    np.testing.assert_allclose(tflow._downsample(_t(img)).numpy(), down, **FLOW_TOL)
    coarse = rng.randn(2, *down.shape[1:], 2).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(coarse), (2, *size, 2), method="bilinear")
                     / jflow.PYR_SCALE)
    np.testing.assert_allclose(tflow._upsample_flow(_t(coarse), *size).numpy(), ref, **FLOW_TOL)


def test_tvl1_stencils_match_jax(rng):
    u = rng.randn(2, 9, 12).astype(np.float32)
    v = rng.randn(2, 9, 12).astype(np.float32)
    for fn in ("_forward_gradient", "_central_gradient"):
        for got, ref in zip(getattr(ttvl1, fn)(_t(u)), getattr(jtvl1, fn)(jnp.asarray(u))):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FLOW_TOL)
    np.testing.assert_allclose(ttvl1._divergence(_t(u), _t(v)).numpy(),
                               np.asarray(jtvl1._divergence(jnp.asarray(u), jnp.asarray(v))),
                               **FLOW_TOL)
    for name in ("TAU", "LAMBDA", "THETA", "LEVELS", "WARPS", "INNER_ITERATIONS", "GRAD_EPS"):
        assert getattr(ttvl1, name) == getattr(jtvl1, name), name


# ------------------------------------------------------------- whole flows

FLOWS = {"farneback": (tflow.compute_flow_device, jflow.compute_flow_device),
         "tvl1": (ttvl1.compute_flow_tvl1, jtvl1.compute_flow_tvl1)}


@pytest.mark.parametrize("size", [(48, 64), (51, 67)], ids=["48x64", "odd_51x67"])
@pytest.mark.parametrize("algorithm", sorted(FLOWS))
def test_whole_flow_matches_jax(algorithm, size):
    """Five textured frames translated by (1.3, -0.7) px per frame: max
    |difference| within 1e-3 px (the transcription measured at most 8.4e-5)
    and the uint8 flow the extractor consumes equal."""
    port, ref_fn = FLOWS[algorithm]
    frames = textured_scene(5, *size)
    ref = np.asarray(ref_fn(jnp.asarray(frames)))
    got = port(_t(frames)).numpy()
    assert got.shape == ref.shape == (5, *size, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got[0], 0.0)
    assert np.abs(got - ref).max() * tflow.FLOW_BOUND <= 1e-3
    np.testing.assert_array_equal(tdflow.flow_to_uint8(_t(got)).numpy(), jdflow.flow_to_uint8(ref))


@pytest.mark.parametrize("dx,dy", [(3.0, -2.0), (0.5, 1.25), (-4.0, 0.0)])
@pytest.mark.parametrize("algorithm", sorted(FLOWS))
def test_translation_recovered(algorithm, dx, dy):
    """tests/test_flow.py's and tests/test_tvl1.py's scenes and tolerances:
    the median flow inside the frame within 0.3 px (Farneback) or 0.03 px
    (TV-L1) of the true shift."""
    img = smooth_image()
    shifted = scipy_ndimage.shift(img, (dy, dx), order=1, mode="nearest")
    flow = FLOWS[algorithm][0](_t(to_rgb(img, shifted))).numpy() * tflow.FLOW_BOUND
    est = np.median(flow[1, 30:-30, 30:-30].reshape(-1, 2), axis=0)
    np.testing.assert_allclose(est, [dx, dy], atol=0.3 if algorithm == "farneback" else 0.03)


@pytest.mark.parametrize("algorithm", sorted(FLOWS))
def test_sub_batched_pairs_equal_one_batch(algorithm):
    """A chunk's pairs in sub-batches of 2 (overlapping by one frame, an
    uneven last batch) equal the chunk in one sub-batch: pairs are
    independent."""
    port = FLOWS[algorithm][0]
    frames = _t(textured_scene(6, 24, 32))
    whole = port(frames, pairs=5)
    for pairs in (2, 3):
        torch.testing.assert_close(port(frames, pairs=pairs), whole, atol=0, rtol=0)
    with pytest.raises(ValueError, match="uint8"):
        port(frames.float())


def test_full_f32_blocks_on_two_threads_restore_once():
    """A flow's TF32-off block on one thread and a resize's on another: the
    flags stay off until the last block exits, then return to what the
    first block found."""
    import threading

    from anomaly_detection_on_video_tpu_torch.utils.device import full_f32

    flags = lambda: (torch.backends.cuda.matmul.allow_tf32,  # noqa: E731
                     torch.backends.cudnn.allow_tf32)
    saved = flags()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    entered, release = threading.Event(), threading.Event()

    def other():
        with full_f32():
            entered.set()
            release.wait(10)

    try:
        with full_f32():
            thread = threading.Thread(target=other)
            thread.start()
            assert entered.wait(10)
        assert flags() == (False, False)  # the other thread's block is still open
        release.set()
        thread.join(10)
        assert flags() == (False, True)
    finally:
        release.set()
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
