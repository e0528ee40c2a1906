"""PyTorch port vs the JAX package: the MGFN train step.

Losses, batch-mode BatchNorm, gradients, the Adam-with-L2 trajectory (with
and without clipping), gradient accumulation and bf16-mixed, each against
the JAX function on the same inputs and weights. The dynamics tests run in
float64 at a reduced width (every stage, both block types, the
intermediates, BN, top-k, all losses and the optimizer are width
independent), with the selection dropout off: its draws cannot be matched
across frameworks. Norm parameters are randomized so the top-k selection
has no ties.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anomaly_detection_on_video_tpu.losses import base as jbase
from anomaly_detection_on_video_tpu.losses import mgfn as jmgfn
from anomaly_detection_on_video_tpu.models.mgfn import MGFNConfig as JConfig
from anomaly_detection_on_video_tpu.models.mgfn import MGFNForVideoAnomalyDetection
from anomaly_detection_on_video_tpu.models.mgfn.model import TorchBatchNorm as JBatchNorm
from anomaly_detection_on_video_tpu.training.optim import adam_with_l2 as j_adam_with_l2
from anomaly_detection_on_video_tpu.training.runner import TrainState as JTrainState
from anomaly_detection_on_video_tpu.training.runner import make_train_step as j_make_train_step
from anomaly_detection_on_video_tpu_torch.losses import base as tbase
from anomaly_detection_on_video_tpu_torch.losses import mgfn as tmgfn
from anomaly_detection_on_video_tpu_torch.models.mgfn import MGFN, MGFNConfig
from anomaly_detection_on_video_tpu_torch.models.mgfn.model import (
    TorchBatchNorm,
    _magnitude_selection,
)
from anomaly_detection_on_video_tpu_torch.training.optim import (
    AdamWithL2,
    build_optimizer,
    clip_by_global_norm_,
)
from anomaly_detection_on_video_tpu_torch.training.runner import TrainState, make_train_step
from anomaly_detection_on_video_tpu_torch.utils.convert import mgfn_state_dict_from_flax
from test_torch_mgfn import randomize_norms

DYN = dict(dims=(16, 32, 64), depths=(1, 1, 1), channels=64, dim_head=8, dropout_rate=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread keeps torch from
    contending with the other test workers' threads, which slowed this
    file several times over when every worker ran torch's default pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f64(a):
    return torch.from_numpy(np.asarray(a, np.float64))


# ----------------------------------------------------------------- losses

def _loss_cases(rng):
    s = rng.rand(3, 7, 1)
    a, b = rng.randn(6, 3), rng.randn(6, 3)
    near = a + 1e-9  # the eps inside the difference dominates
    probs = np.array([0.0, 1.0, 0.3, 0.9, 1e-50, 1.0 - 1e-17])
    labels = np.array([1.0, 0.0, 0.0, 1.0, 1.0, 0.0])
    feats = rng.randn(4, 3, 5), rng.randn(4, 3, 5)
    return {
        "smoothness": (lambda m, *x: m.smoothness_loss(*x), (s,)),
        "sparsity": (lambda m, *x: m.sparsity_loss(*x), (s[:2].reshape(-1),)),
        "pairwise": (lambda m, *x: m.pairwise_distance(*x), (a, b)),
        "pairwise_eps": (lambda m, *x: m.pairwise_distance(*x), (a, near)),
        "contrastive_pull": (lambda m, *x: m.contrastive_loss(*x, 0.0), (a, b)),
        "contrastive_push": (lambda m, *x: m.contrastive_loss(*x, 1.0), (a * 50, b * 80)),
        "bce_clamped": (lambda m, *x: m.bce_loss(*x), (probs, labels)),
        "mgfn": (lambda m, *x: m.mgfn_loss(*x),
                 (rng.rand(2, 1), rng.rand(2, 1), feats[0], feats[1], np.ones(2), np.zeros(2))),
    }


@pytest.mark.parametrize("name", ["smoothness", "sparsity", "pairwise", "pairwise_eps",
                                  "contrastive_pull", "contrastive_push", "bce_clamped", "mgfn"])
def test_losses_match_jax_f64(rng, name):
    fn, args = _loss_cases(rng)[name]
    module_j = jmgfn if name.startswith(("bce", "mgfn")) else jbase
    module_t = tmgfn if name.startswith(("bce", "mgfn")) else tbase
    with jax.enable_x64(True):
        ref = np.asarray(fn(module_j, *(jnp.asarray(a, jnp.float64) for a in args)))
    got = fn(module_t, *(_f64(a) for a in args)).numpy()
    assert np.isfinite(ref).all() and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)


def test_batch_norm_train_mode_matches_jax_f64(rng):
    x = rng.randn(6, 9, 5) * 2 + 0.5  # (batch, clips, channels), JAX layout
    scale, bias = rng.rand(5) + 0.5, rng.randn(5)
    mean, var = rng.randn(5) * 0.1, rng.rand(5) + 0.5
    with jax.enable_x64(True):
        variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                     "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
        ref, upd = JBatchNorm(5).apply(variables, jnp.asarray(x), False, mutable=["batch_stats"])
    bn = TorchBatchNorm(5).double().train()
    with torch.no_grad():
        bn.weight.copy_(_f64(scale))
        bn.bias.copy_(_f64(bias))
        bn.running_mean.copy_(_f64(mean))
        bn.running_var.copy_(_f64(var))
    got = bn(_f64(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-10, atol=1e-12)


# ------------------------------------------------------- the train step

_INITS = {}


def _init(model, cfg):
    """The flax init of ``model`` (the same values eagerly or jitted),
    compiled once per config for the file's tests."""
    key = tuple(sorted(cfg.items()))
    if key not in _INITS:
        video = jnp.zeros((2, 10, 16, cfg["channels"] + 1), jnp.float32)
        _INITS[key] = jax.tree_util.tree_map(
            np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), video))
    return _INITS[key]


def _pair(seed=11, **overrides):
    """A flax MGFN with randomized norms and the port's MGFN (float64,
    train mode) holding the same weights."""
    cfg = dict(DYN, **overrides)
    model = MGFNForVideoAnomalyDetection(JConfig(**cfg))
    variables = randomize_norms(_init(model, cfg), np.random.RandomState(seed))
    port = MGFN(MGFNConfig(**cfg))
    port.load_state_dict(mgfn_state_dict_from_flax(variables))
    return model, variables, port.double().train()


def _batch(seed, bs=4, t=16, channels=DYN["channels"]):
    rng = np.random.RandomState(seed)
    video = np.abs(rng.randn(bs, 10, t, channels + 1)) * 0.5
    return video, np.zeros(bs // 2), np.ones(bs // 2)


def _as_x64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _as_torch_names(variables):
    """A flax {"params", "batch_stats"} tree -> the port's names."""
    return {k: v.numpy() for k, v in mgfn_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables)).items()}


def _assert_state_close(port, jax_variables, rtol_p, atol_p, rtol_s, atol_s):
    ref = _as_torch_names(jax_variables)
    for name, value in port.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        stat = "running_" in name
        np.testing.assert_allclose(value.numpy(), ref[name], rtol=rtol_s if stat else rtol_p,
                                   atol=atol_s if stat else atol_p, err_msg=name)


def test_gradients_match_jax_f64():
    """Per-parameter gradients of one train-mode forward/backward."""
    model, variables, port = _pair()
    video, nlabels, alabels = _batch(20)
    with jax.enable_x64(True):
        v64 = _as_x64(variables)

        def loss_fn(params):
            out, _ = model.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                 jnp.asarray(video), abnormal_labels=jnp.asarray(alabels),
                                 normal_labels=jnp.asarray(nlabels), train=True,
                                 rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
            return out.loss

        grads = jax.jit(jax.grad(loss_fn))(v64["params"])
        ref = _as_torch_names({"params": grads, "batch_stats": v64["batch_stats"]})
    out = port.outputs(_f64(video), _f64(alabels), _f64(nlabels), train=True)
    out.loss.backward()
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], rtol=1e-8, atol=1e-10, err_msg=name)


def _run_jax_steps(variables, batches, n_steps, grad_clip=None, microbatched=False):
    with jax.enable_x64(True):
        state = JTrainState.create(
            MGFNForVideoAnomalyDetection(JConfig(**DYN)), _as_x64(variables),
            j_adam_with_l2(1e-3, 5e-4, grad_clip=grad_clip))
        step_fn = j_make_train_step(microbatched=microbatched)
        losses = []
        for i in range(n_steps):
            video, nlabels, alabels = batches[i % len(batches)]
            key = jax.random.PRNGKey(i)
            if microbatched:
                key = jax.random.split(key, video.shape[0])
            state, loss = step_fn(state, jnp.asarray(video), jnp.asarray(nlabels),
                                  jnp.asarray(alabels), key)
            losses.append(float(loss))
        return losses, jax.tree_util.tree_map(np.asarray, state.variables)


def _run_port_steps(port, batches, n_steps, grad_clip=None, microbatched=False):
    state = TrainState(port, AdamWithL2(port.parameters(), 1e-3, 5e-4, grad_clip))
    step_fn = make_train_step(microbatched=microbatched)
    losses = []
    for i in range(n_steps):
        video, nlabels, alabels = batches[i % len(batches)]
        loss = step_fn(state, _f64(video), _f64(nlabels), _f64(alabels))
        assert loss.dtype == torch.float32
        losses.append(float(loss))
    assert state.step == n_steps
    return losses


@pytest.mark.parametrize("grad_clip", [None, 0.05], ids=["no_clip", "clip"])
def test_adam_trajectory_matches_jax_f64(grad_clip):
    """12 steps of Adam with coupled L2 at lr 1e-3 / wd 5e-4 through both
    train steps: losses, parameters and BN running statistics."""
    _, variables, port = _pair()
    batches = [_batch(seed) for seed in (30, 31, 32)]
    if grad_clip is not None:  # the clip must bite on the first step
        probe = copy.deepcopy(port)
        video, nlabels, alabels = batches[0]
        probe.outputs(_f64(video), _f64(alabels), _f64(nlabels), train=True).loss.backward()
        assert torch.sqrt(sum((p.grad ** 2).sum() for p in probe.parameters())) > 4 * grad_clip
    ref_losses, ref_vars = _run_jax_steps(variables, batches, 12, grad_clip)
    losses = _run_port_steps(port, batches, 12, grad_clip)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    _assert_state_close(port, ref_vars, 1e-6, 1e-9, 1e-8, 1e-10)


def test_accumulated_step_matches_jax_f64():
    """k = 2 micro-batches per optimizer step: BN statistics thread through
    them, gradients and losses are averaged, the optimizer runs once."""
    _, variables, port = _pair()
    singles = [_batch(seed) for seed in (40, 41, 42, 43)]
    stacked = [tuple(np.stack([b[i] for b in singles[j:j + 2]]) for i in range(3))
               for j in (0, 2)]
    ref_losses, ref_vars = _run_jax_steps(variables, stacked, 4, microbatched=True)
    losses = _run_port_steps(port, stacked, 4, microbatched=True)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    _assert_state_close(port, ref_vars, 1e-6, 1e-9, 1e-8, 1e-10)


def test_bf16_mixed_step_matches_jax_and_keeps_float32_masters():
    model, variables, port = _pair()
    port.float()
    video, nlabels, alabels = (a.astype(np.float32) for a in _batch(50))
    state = JTrainState.create(model, jax.tree_util.tree_map(jnp.asarray, variables),
                               j_adam_with_l2(1e-3, 5e-4))
    _, ref = j_make_train_step(precision="bf16-mixed")(
        state, jnp.asarray(video), jnp.asarray(nlabels), jnp.asarray(alabels),
        jax.random.PRNGKey(0))
    tstate = TrainState(port, AdamWithL2(port.parameters()))
    loss = make_train_step(precision="bf16-mixed")(
        tstate, torch.from_numpy(video), torch.from_numpy(nlabels), torch.from_numpy(alabels))
    assert loss.dtype == torch.float32 and np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(ref), rtol=0.05, atol=0.05)
    for name, value in port.state_dict().items():
        if value.is_floating_point():
            assert value.dtype == torch.float32, name
    for p in port.parameters():
        assert p.grad.dtype == torch.float32
        for moment in tstate.optimizer.state[p].values():
            if moment.is_floating_point() and moment.dim():
                assert moment.dtype == torch.float32
    with pytest.raises(ValueError, match="precision"):
        make_train_step(precision="16-mixed")


def test_selection_dropout_stays_in_valid_clips_and_follows_its_generator():
    """dropout_rate 0.7: the selected clips lie in each video's valid
    prefix (padded clips carry magnitude -1, as the model masks them), and
    one generator seed gives the same selection."""
    n, ncrops, t, k = 6, 3, 32, 3
    valid = torch.tensor([20, 32, 9, 15, 32, 25])
    rng = np.random.RandomState(1)
    mags = torch.from_numpy(rng.rand(n, t) + 0.5)
    mags = torch.where(torch.arange(t)[None] < valid[:, None], mags, -1.0)
    # feature channel 0 holds the clip index, so the selection reads back
    feats = torch.arange(t, dtype=torch.float64)[None, :, None].expand(n * ncrops, t, 2).clone()
    scores = torch.from_numpy(rng.rand(n, t, 1))

    def select(seed):
        gen = torch.Generator().manual_seed(seed)
        sel, top = _magnitude_selection(mags, feats, scores, k, ncrops, 0.7, gen)
        return sel[..., 0].long().reshape(ncrops, n, k), top

    idx, top = select(3)
    assert (idx == idx[:1]).all()  # every crop takes its sample's clips
    assert (idx[0] < valid[:, None]).all()
    np.testing.assert_array_equal(top.numpy(),
                                  torch.gather(scores, 1, idx[0][..., None]).mean(1).numpy())
    again, _ = select(3)
    torch.testing.assert_close(again, idx)
    assert any(not torch.equal(select(s)[0], idx) for s in (4, 5, 6))
    no_dropout = torch.topk(mags, k, dim=1).indices
    assert not torch.equal(idx[0], no_dropout)
    with pytest.raises(ValueError, match="Generator"):
        _magnitude_selection(mags, feats, scores, k, ncrops, 0.7, None)


def test_clip_and_optimizer_builders(rng):
    """The clip scales by max_norm / norm only past max_norm (optax's
    formula), and the builders map to the torch optimizers."""
    grads = [torch.from_numpy(rng.randn(3, 4)), torch.from_numpy(rng.randn(5))]
    norm = float(np.sqrt(sum((g.numpy() ** 2).sum() for g in grads)))
    kept = [g.clone() for g in grads]
    assert float(clip_by_global_norm_(kept, norm * 2)) == pytest.approx(norm)
    for a, b in zip(kept, grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    clipped = [g.clone() for g in grads]
    clip_by_global_norm_(clipped, 0.5)
    for a, b in zip(clipped, grads):
        torch.testing.assert_close(a, b / norm * 0.5, rtol=0, atol=0)
    params = [torch.nn.Parameter(torch.zeros(2))]
    assert isinstance(build_optimizer(params, "adam", learning_rate=1e-3), AdamWithL2)
    assert isinstance(build_optimizer(params, "adamw", learning_rate=1e-3), torch.optim.AdamW)
    assert isinstance(build_optimizer(params, "sgd", learning_rate=1e-3), torch.optim.SGD)
    with pytest.raises(KeyError):
        build_optimizer(params, "lion", learning_rate=1e-3)
