"""PyTorch port vs the JAX package: the RTFM and Sultani scorers and the
scorer weight loaders.

Eval scores in float32 (unpadded, bucket-padded with a scalar or a
per-video length, a video shorter than top-k), the training outputs and
per-parameter gradients in float64 with dropout off (the frameworks' dropout
draws cannot be matched; a separate test holds the port's dropout to its
generator and rate), and the loaders of the reference's layouts: the
official RTFM release with BatchNorms folded and Sultani's ``fc1``-``fc3``
(the official MGFN release remap is held through the CLI, in
tests/test_torch_infer.py). One flax init feeds both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anomaly_detection_on_video_tpu.models import build_model as j_build_model
from anomaly_detection_on_video_tpu.utils import convert as jconvert
from anomaly_detection_on_video_tpu_torch.models import build_model
from anomaly_detection_on_video_tpu_torch.models.common import dropout
from anomaly_detection_on_video_tpu_torch.utils import convert as tconvert

NARROW = {"rtfm": dict(channels=64, hidden_dims=(32, 16)),
          "sultani": dict(channels=64, hidden_dims=(32, 16))}
FROM_FLAX = {"rtfm": tconvert.rtfm_state_dict_from_flax,
             "sultani": tconvert.sultani_state_dict_from_flax}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread keeps torch from
    contending with the other test workers' threads, as in
    tests/test_torch_train.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_biases(variables, seed):
    """Every bias random: flax initializes them to zero, which would hide
    a pad that a conv's bias makes nonzero."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.randn(*a.shape) * 0.3).astype(a.dtype)
        if path[-1].key == "bias" else np.asarray(a), variables)


def build_pair(name, seed=0, **overrides):
    """A flax scorer's variables (random biases) and the port's scorer
    holding them."""
    cfg = dict(NARROW[name], **overrides)
    _, model = j_build_model(name, **cfg)
    video = jnp.zeros((2, 3, 8, cfg["channels"] + 1), jnp.float32)
    variables = random_biases(model.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)}, video), seed)
    _, port = build_model(name, **cfg)
    port.load_state_dict(FROM_FLAX[name](variables))
    return model, variables, port.eval()


def _video(rng, bs, ncrops, t, channels=64):
    return (np.abs(rng.randn(bs, ncrops, t, channels + 1)) * 0.5).astype(np.float32)


def _pad(video, bucket):
    out = np.zeros(video.shape[:2] + (bucket,) + video.shape[3:], video.dtype)
    out[:, :, : video.shape[2]] = video
    return out


# length: None (unpadded), a scalar, a per-video vector; "short": 2 valid clips < k = 3
CASES = {"unpadded": (1, 12, None), "scalar_length": (1, 32, 7), "vector_length": (2, 32, (10, 7)),
         "short": (2, 32, (2, 9))}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", ["rtfm", "sultani"])
def test_eval_scores_match_jax(rng, name, case):
    """Eval scores and the top-k / max outputs, float32, at 1e-5."""
    model, variables, port = build_pair(name)
    bs, t, length = CASES[case]
    video = _video(rng, bs, 3, t)
    j_length = None if length is None else jnp.asarray(length)
    ref = model.apply(variables, jnp.asarray(video), length=j_length)
    t_length = None if length is None else torch.tensor(length)
    with torch.no_grad():
        scores = port(torch.from_numpy(video), length=t_length)
        out = port.outputs(torch.from_numpy(video), length=t_length)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref.scores), atol=1e-5, rtol=1e-5)
    for key in ("abnormal_scores", "normal_scores"):
        np.testing.assert_allclose(getattr(out, key).numpy(), np.asarray(getattr(ref, key)),
                                   atol=1e-5, rtol=1e-5, err_msg=key)
    if length is not None:
        valid = np.arange(t)[None] < np.reshape(length, (-1, 1))
        assert (scores.numpy()[..., 0][~np.broadcast_to(valid, (bs, t))] == 0).all()


@pytest.mark.parametrize("name", ["rtfm", "sultani"])
def test_padded_buckets_equal_unpadded(rng, name):
    """A 5-clip video scores the same unpadded, at bucket 32 and at bucket
    64 (masked convs, masked attention values, the true-length divisor)."""
    _, _, port = build_pair(name)
    video = _video(rng, 1, 3, 5)
    with torch.no_grad():
        plain = port(torch.from_numpy(video))[0, :, 0]
        at = {b: port(torch.from_numpy(_pad(video, b)), length=torch.tensor(5))[0, :5, 0]
              for b in (32, 64)}
    np.testing.assert_array_equal(at[32].numpy(), at[64].numpy())
    np.testing.assert_allclose(at[32].numpy(), plain.numpy(), atol=1e-6, rtol=1e-6)


def _f64(a):
    return torch.from_numpy(np.asarray(a, np.float64))


@pytest.mark.parametrize("name", ["rtfm", "sultani"])
def test_train_outputs_and_gradients_match_jax_f64(name):
    """Train mode at float64, dropout off: loss and both top-k / max
    outputs to 1e-10, per-parameter gradients against jax.grad."""
    model, variables, port = build_pair(name, seed=3, dropout_rate=0.0)
    port = port.double().train()
    rng = np.random.RandomState(20)
    video = np.abs(rng.randn(4, 3, 16, 65)) * 0.5
    nlabels, alabels = np.zeros(2), np.ones(2)
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables["params"])

        def apply(p):
            return model.apply({"params": p}, jnp.asarray(video), abnormal_labels=jnp.asarray(alabels),
                               normal_labels=jnp.asarray(nlabels), train=True,
                               rngs={"dropout": jax.random.PRNGKey(0)})

        ref = apply(params)
        grads = jax.jit(jax.grad(lambda p: apply(p).loss))(params)
        ref_grads = {k: v.numpy() for k, v in FROM_FLAX[name](
            {"params": jax.tree_util.tree_map(np.asarray, grads)}).items()}
        ref = jax.tree_util.tree_map(np.asarray, (ref.loss, ref.abnormal_scores, ref.normal_scores))
    out = port.outputs(_f64(video), _f64(alabels), _f64(nlabels), train=True)
    for got, want in zip((out.loss, out.abnormal_scores, out.normal_scores), ref):
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-10, rtol=1e-10)
    out.loss.backward()
    for key, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[key], rtol=1e-8, atol=1e-10,
                                   err_msg=key)


@pytest.mark.parametrize("name", ["rtfm", "sultani"])
def test_dropout_follows_its_generator_and_rate(name):
    """One generator seed gives one mask; rate 0.7 zeroes about 70% and
    scales the kept values by 1 / 0.3; the train step's loss follows the
    seed; train mode without a generator raises."""
    x = torch.ones(200, 500, dtype=torch.float64)
    a = dropout(x, 0.7, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, dropout(x, 0.7, torch.Generator().manual_seed(3)))
    assert not torch.equal(a, dropout(x, 0.7, torch.Generator().manual_seed(4)))
    assert abs(float((a == 0).double().mean()) - 0.7) < 0.01
    np.testing.assert_allclose(a[a != 0].numpy(), 1.0 / 0.3)
    assert dropout(x, 0.0, None) is x

    _, _, port = build_pair(name)
    port.train()
    video = torch.from_numpy(_video(np.random.RandomState(1), 4, 3, 16))
    labels = torch.zeros(2), torch.ones(2)

    def loss(seed):
        return port.outputs(video, labels[1], labels[0], generator=torch.Generator().manual_seed(seed)).loss

    assert float(loss(5).detach()) == float(loss(5).detach()) != float(loss(6).detach())
    with pytest.raises(ValueError, match="Generator"):
        port.outputs(video, labels[1], labels[0])
    with pytest.raises(ValueError, match="train=False"):
        port.outputs(video, train=False)


# ----------------------------------------------------------- weight loaders

def _official_rtfm(rng, bn_at=("conv_1", "conv_5", "non_local.W"), bn_index=1):
    """An official-layout RTFM state dict (the flax init exported by the
    JAX package), with a random eval-mode BatchNorm at ``bn_index`` of each
    named Sequential."""
    _, variables, _ = build_pair("rtfm", seed=4)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          jconvert.export_rtfm_state_dict(variables).items()}
    for name in bn_at:
        n = sd[f"Aggregate.{name}.0.weight"].shape[0]
        prefix = f"Aggregate.{name}.{bn_index}"
        sd[prefix + ".weight"] = torch.from_numpy((rng.rand(n) + 0.5).astype(np.float32))
        sd[prefix + ".bias"] = torch.from_numpy((rng.randn(n) * 0.2).astype(np.float32))
        sd[prefix + ".running_mean"] = torch.from_numpy((rng.randn(n) * 0.1).astype(np.float32))
        sd[prefix + ".running_var"] = torch.from_numpy((rng.rand(n) + 0.5).astype(np.float32))
        sd[prefix + ".num_batches_tracked"] = torch.tensor(7)
    return sd


def test_official_rtfm_loader_folds_bn_as_jax(rng):
    """Random BN statistics after conv_1, conv_5 and non_local.W: the
    port's loader folds to the same float32 values as the JAX converter,
    and its forward matches JAX's apply at 1e-5."""
    sd = _official_rtfm(rng)
    j_vars = jconvert.convert_rtfm_state_dict(sd)
    got = tconvert.rtfm_state_dict_from_official(sd)
    want = tconvert.rtfm_state_dict_from_flax(j_vars)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)
    _, port = build_model("rtfm", **NARROW["rtfm"])
    port.load_state_dict(got)
    video = _video(rng, 2, 3, 32)
    _, model = j_build_model("rtfm", **NARROW["rtfm"])
    ref = model.apply(j_vars, jnp.asarray(video), length=jnp.asarray([9, 32]))
    with torch.no_grad():
        scores = port.eval()(torch.from_numpy(video), length=torch.tensor([9, 32]))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref.scores), atol=1e-5, rtol=1e-5)


def test_official_rtfm_loader_rejects_what_jax_rejects(rng):
    """A BN after the ReLU (index 2), and a BN after the bias-free conv_4
    with a nonzero shift, raise in both packages; an identity-shift BN
    there converts, leaving conv_4 bias-free."""
    after_relu = _official_rtfm(rng, bn_at=("conv_2",), bn_index=2)
    for convert in (jconvert.convert_rtfm_state_dict, tconvert.rtfm_state_dict_from_official):
        with pytest.raises(ValueError, match="after ReLU"):
            convert(after_relu)
    shifted = _official_rtfm(rng, bn_at=("conv_4",))
    for convert in (jconvert.convert_rtfm_state_dict, tconvert.rtfm_state_dict_from_official):
        with pytest.raises(ValueError, match="conv_4.*bias-free"):
            convert(shifted)
    shifted["Aggregate.conv_4.1.running_mean"].zero_()
    shifted["Aggregate.conv_4.1.bias"].zero_()
    sd = tconvert.rtfm_state_dict_from_official(shifted)
    assert "Aggregate.conv_4.0.bias" not in sd
    assert "bias" not in jconvert.convert_rtfm_state_dict(shifted)["params"]["aggregate"]["proj"]
    build_model("rtfm", **NARROW["rtfm"])[1].load_state_dict(sd)


def test_sultani_loader_matches_jax(rng):
    """Sultani's ``fc1``-``fc3`` layout loads as is: the port against JAX's
    ``convert_sultani_state_dict`` + apply."""
    _, variables, _ = build_pair("sultani", seed=6)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          jconvert.export_sultani_state_dict(variables).items()}
    _, port = build_model("sultani", **NARROW["sultani"])
    port.load_state_dict(sd)
    video = _video(rng, 1, 3, 20)
    _, model = j_build_model("sultani", **NARROW["sultani"])
    ref = model.apply(jconvert.convert_sultani_state_dict(sd), jnp.asarray(video)).scores
    with torch.no_grad():
        scores = port.eval()(torch.from_numpy(video))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
