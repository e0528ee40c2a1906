"""PyTorch port vs the JAX package: MGFN scores, bucket masking, AUC, the
MGFN weight converter and the eval step.

A narrow config keeps it cheap; LayerNorm parameters and BatchNorm
statistics are randomized so the comparison does not hinge on identity
normalization, which also leaves the clip scores free of ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anomaly_detection_on_video_tpu.data.features import pad_eval_batch as j_pad_eval_batch
from anomaly_detection_on_video_tpu.models.mgfn import MGFNConfig as JConfig
from anomaly_detection_on_video_tpu.models.mgfn import MGFNForVideoAnomalyDetection
from anomaly_detection_on_video_tpu.ops import metrics as jmetrics
from anomaly_detection_on_video_tpu.training.runner import eval_bucket as j_eval_bucket
from anomaly_detection_on_video_tpu.utils.convert import export_mgfn_state_dict
from anomaly_detection_on_video_tpu_torch.data.features import pad_eval_batch
from anomaly_detection_on_video_tpu_torch.models.mgfn import MGFN, MGFNConfig
from anomaly_detection_on_video_tpu_torch.ops import metrics as tmetrics
from anomaly_detection_on_video_tpu_torch.training.runner import eval_bucket, make_eval_step
from anomaly_detection_on_video_tpu_torch.utils.convert import mgfn_state_dict_from_flax
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as in tests/test_torch_train.py: torch's default
    pool contends with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NARROW = dict(dims=(16, 16, 32), depths=(1, 1, 1), dim_head=8, channels=64)


def randomize_norms(variables, rng):
    """Random channel-LayerNorm g/b, head LayerNorm and BatchNorm params and
    running statistics."""
    variables = jax.tree_util.tree_map(lambda a: np.array(a), variables)

    def walk(node):
        for key, child in node.items():
            if not isinstance(child, dict):
                continue
            leaves = set(child)
            if leaves in ({"g", "b"}, {"scale", "bias"}):
                n = child[sorted(leaves)[0]].shape[0]
                gain, shift = ("g", "b") if "g" in leaves else ("scale", "bias")
                child[gain] = (rng.rand(n) + 0.5).astype(np.float32)
                child[shift] = (rng.randn(n) * 0.2).astype(np.float32)
            elif leaves == {"mean", "var"}:
                n = child["mean"].shape[0]
                child["mean"] = (rng.randn(n) * 0.1).astype(np.float32)
                child["var"] = (rng.rand(n) + 0.5).astype(np.float32)
            else:
                walk(child)

    walk(variables)
    return variables


_INITS = {}


def build_pair(rng, ncrops=3, t=12, **overrides):
    """A flax MGFN and the port's MGFN holding the same random weights (the
    flax init, the same values eagerly or jitted, compiled once per shape
    and config)."""
    cfg = dict(NARROW, **overrides)
    model = MGFNForVideoAnomalyDetection(JConfig(**cfg))
    key = (ncrops, t, tuple(sorted(cfg.items())))
    if key not in _INITS:
        video = jnp.zeros((2, ncrops, t, cfg["channels"] + 1), jnp.float32)
        _INITS[key] = jax.tree_util.tree_map(
            np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), video))
    variables = randomize_norms(_INITS[key], rng)
    port = MGFN(MGFNConfig(**cfg))
    port.load_state_dict(mgfn_state_dict_from_flax(variables))
    return model, variables, port.eval()


def _jax_scores(model, variables, video, length=None):
    """The flax model's scores, jitted: one compile instead of op-by-op
    dispatch."""
    fn = jax.jit(lambda v, x, n: model.apply(v, x, length=n).scores)
    return np.asarray(fn(variables, jnp.asarray(video), None if length is None
                         else jnp.asarray(length)))


def _features(rng, *shape):
    return (np.abs(rng.randn(*shape)) * 0.5).astype(np.float32)


def test_scores_match_jax_unmasked(rng):
    model, variables, port = build_pair(rng)
    video = _features(rng, 2, 3, 12, 65)
    ref = _jax_scores(model, variables, video)
    with torch.no_grad():
        got = port(torch.from_numpy(video)).numpy()
    assert got.shape == ref.shape == (2, 12, 1)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("lengths", [(10,), (10, 7)])
def test_scores_match_jax_on_padded_bucket(rng, lengths):
    """Scalar and per-video ``length`` masking on a 32-clip bucket."""
    model, variables, port = build_pair(rng)
    video = np.zeros((len(lengths), 3, 32, 65), np.float32)
    for i, n in enumerate(lengths):
        video[i, :, :n] = _features(rng, 3, n, 65)
    length = np.asarray(lengths if len(lengths) > 1 else lengths[0], np.int32)
    ref = _jax_scores(model, variables, video, length)
    with torch.no_grad():
        got = port(torch.from_numpy(video), length=torch.from_numpy(length)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    for i, n in enumerate(lengths):
        assert np.all(got[i, n:] == 0)


def test_padded_bucket_equals_unpadded(rng):
    """Masking makes the padded run's valid prefix equal the unpadded run."""
    _, _, port = build_pair(rng)
    feats = _features(rng, 10, 3, 64)  # (n_clips, n_crops, C)
    padded = pad_eval_batch(feats, eval_bucket(10))
    np.testing.assert_array_equal(padded, j_pad_eval_batch(feats, j_eval_bucket(10)))
    step = make_eval_step()
    padded_scores = step(port, torch.from_numpy(padded), torch.tensor([10]))[0, :10]
    with torch.no_grad():
        unpadded = port(torch.from_numpy(padded[:, :, :10]))[0]
    torch.testing.assert_close(padded_scores, unpadded, atol=1e-6, rtol=0)


def test_frame_level_auc_equal(rng):
    model, variables, port = build_pair(rng)
    feats = _features(rng, 20, 3, 64)
    batch = pad_eval_batch(feats, eval_bucket(20))
    ref = _jax_scores(model, variables, batch, [20])[0, :20, 0]
    got = make_eval_step()(port, torch.from_numpy(batch), torch.tensor([20]))[0, :20, 0].numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    labels = np.repeat((rng.rand(20) > 0.5).astype(np.float64), 16)
    t_frames = tmetrics.frame_level_scores(got, 16)
    j_frames = jmetrics.frame_level_scores(ref, 16)
    assert tmetrics.roc_auc(labels, t_frames) == jmetrics.roc_auc(labels, j_frames)
    assert tmetrics.pr_auc(labels, t_frames) == jmetrics.pr_auc(labels, j_frames)
    for n in (1, 31, 32, 33, 200):
        assert eval_bucket(n) == j_eval_bucket(n)


def test_mgfn_converter_equals_export(rng):
    """Port converter == JAX exporter, key by key, bit by bit; the default
    (full-width) config loads the exported names and shapes strictly."""
    _, variables, _ = build_pair(rng)
    ref = export_mgfn_state_dict(variables)
    got = mgfn_state_dict_from_flax(variables)
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)

    model = MGFNForVideoAnomalyDetection(JConfig())
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 10, 32, 2049)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    MGFN(MGFNConfig()).load_state_dict(mgfn_state_dict_from_flax(zeros))
