"""PyTorch port vs the JAX package: scale-out on ``torch.distributed``,
one spawn of 4 gloo ranks (``tests/torch_parallel_launch.py spawn``).

Three MGFN steps and one step each of RTFM and Sultani in float64, as DP
over 4 ranks and as DP 2 x TP 2, against the port's single-process step
(1e-12) and the JAX ``make_train_step(mesh)`` over 4 of conftest's 8 CPU
devices with a 1-D and a (2, 2) mesh (1e-10); dropout 0.1 with one shared
generator, BN running statistics, bf16-mixed (by cosine), micro-batches
(k = 2), eval scores and AUCs, a stop signal on rank 1, the store barrier,
rank 0 alone writing, a DP x TP checkpoint read back by a single-device
state and by ``infer.build_scorer``, and per-rank TP state bytes at 1/tp;
the ranks import the port with jax, flax and the JAX package made
unimportable. Each rank runs one torch thread; the ranks' results come
back as ``.npz`` files through a module-scoped fixture.
"""

import os
import sys

import numpy as np
import pytest
import torch

from torch_parallel_launch import (
    DROPOUT,
    LAUNCHER,
    MESHES,
    SCORER_CFG,
    _finish,
    _jax_steps,
    _jax_variables,
    _popen,
    _port_weights,
    eval_runner,
    port_model,
    port_steps,
    state_arrays,
    state_bytes,
)
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Start the 4-rank spawn, compute the in-process references while it
    runs, then wait for it. -> a dict of everything the tests read."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("parallel")
    spawn_out = str(root / "spawn")
    os.makedirs(spawn_out)
    variables = _jax_variables()
    weights = _port_weights(variables)
    torch.save(weights, os.path.join(spawn_out, "weights.pt"))
    logs = [str(root / "spawn.log")]
    procs = [_popen([sys.executable, LAUNCHER, "spawn", spawn_out], logs[0])]
    try:
        out = {"root": root, "weights": weights, "single": {}, "jax": {}}
        for name in SCORER_CFG:
            for key in ("plain", "dropout"):
                overrides = DROPOUT[name] if key == "dropout" else {}
                losses, state = port_steps(name, weights, **overrides)
                out["single"][f"{name}/{key}"] = (losses, state_arrays(state))
            for key in MESHES:
                out["jax"][f"{name}/{key}"] = _jax_steps(name, variables[name], key)
        losses, state = port_steps("mgfn", weights, steps=1, precision="bf16-mixed",
                                   dtype=torch.float32)
        out["single"]["bf16"] = (losses, state_arrays(state))
        out["bf16_initial"] = {k: v.numpy() for k, v in weights["mgfn"].items()}
        losses, state = port_steps("mgfn", weights, steps=1, k=2)
        out["single"]["micro"] = (losses, state_arrays(state))
        runner, result = eval_runner(weights, None)
        out["single"]["eval"] = result
    finally:
        _finish(procs, logs)
        torch.set_num_threads(threads)
    out["ranks"] = [dict(np.load(os.path.join(spawn_out, f"rank{r}.npz"))) for r in range(4)]
    return out


def _params(rank_res, prefix):
    return {k[len(prefix):]: v for k, v in rank_res.items() if k.startswith(prefix)}


def _assert_params(got, want, rtol, atol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("name", list(SCORER_CFG))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_step_matches_single_process_f64(launched, name, mesh):
    """DP over 4 gloo ranks and DP 2 x TP 2: every rank's losses and final
    parameters and BN statistics equal the port's single-process steps."""
    losses, params = launched["single"][f"{name}/plain"]
    for res in launched["ranks"]:
        np.testing.assert_allclose(res[f"{name}/{mesh}/losses"], losses, rtol=1e-12, atol=0)
        _assert_params(_params(res, f"{name}/{mesh}/param/"), params, 1e-12, 1e-12)


@pytest.mark.parametrize("name", list(SCORER_CFG))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_step_matches_jax_mesh_step_f64(launched, name, mesh):
    """The same runs against the JAX ``make_train_step(mesh)`` over 4 CPU
    devices with the (4,) and (2, 2) meshes (dropout 0: the frameworks'
    draws differ). The JAX step returns its loss as float32, the port's
    float64 step its float64 loss: the port's is rounded as the JAX one is."""
    ref_losses, ref_params = launched["jax"][f"{name}/{mesh}"]
    res = launched["ranks"][0]
    np.testing.assert_allclose(np.float32(res[f"{name}/{mesh}/losses"]), ref_losses, rtol=1e-10,
                               atol=0)
    got = _params(res, f"{name}/{mesh}/param/")
    _assert_params({k: got[k] for k in ref_params}, ref_params, 1e-10, 1e-10)


@pytest.mark.parametrize("name", list(SCORER_CFG))
def test_dropout_masks_drawn_at_the_global_shape(launched, name):
    """Dropout 0.1 (and MGFN's selection dropout 0.7) under DP over 4 ranks
    with one shared generator seed drops what the single step drops."""
    losses, params = launched["single"][f"{name}/dropout"]
    plain_losses, _ = launched["single"][f"{name}/plain"]
    assert losses[0] != plain_losses[0]  # the masks do drop
    for res in launched["ranks"]:
        np.testing.assert_allclose(res[f"{name}/dropout/losses"], losses, rtol=1e-12, atol=0)
        _assert_params(_params(res, f"{name}/dropout/param/"), params, 1e-12, 1e-12)


def test_batch_norm_running_statistics_are_global(launched):
    """MGFN's FocusAttention BN: every rank's running mean and variance
    after 3 DP steps are the single device's (global count, unbiased)."""
    _, params = launched["single"]["mgfn/plain"]
    stats = [k for k in params if "running_" in k]
    assert stats
    for res in launched["ranks"]:
        for key in ("dp4", "dp2tp2"):
            got = _params(res, f"mgfn/{key}/param/")
            for k in stats:
                np.testing.assert_allclose(got[k], params[k], rtol=1e-12, atol=1e-14, err_msg=k)
                assert not np.allclose(got[k], launched["weights"]["mgfn"][k].numpy())


def test_bf16_mixed_step_over_ranks(launched):
    """bf16-mixed over 4 ranks: loss within 1e-2 and parameter update
    cosine >= 0.99 against the single bf16-mixed step."""
    losses, params = launched["single"]["bf16"]
    initial = launched["bf16_initial"]
    res = launched["ranks"][0]
    np.testing.assert_allclose(res["bf16/losses"], losses, rtol=1e-2)
    got = _params(res, "bf16/param/")
    keys = [k for k in params if "running_" not in k]
    a = np.concatenate([(got[k] - initial[k]).ravel() for k in keys])
    b = np.concatenate([(params[k] - initial[k]).ravel() for k in keys])
    assert a.dtype == np.float32 and np.dot(a, b) / np.linalg.norm(a) / np.linalg.norm(b) >= 0.99


def test_microbatched_step_over_ranks(launched):
    """k = 2 micro-batches, each sliced on axis 1, over 4 ranks."""
    losses, params = launched["single"]["micro"]
    for res in launched["ranks"]:
        np.testing.assert_allclose(res["micro/losses"], losses, rtol=1e-12, atol=0)
        _assert_params(_params(res, "micro/param/"), params, 1e-12, 1e-12)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_eval_scores_and_aucs_over_ranks(launched, mesh):
    """7 videos, eval_batch_videos 3 rounded up to 4 on a 4-rank mesh:
    the gathered scores and the AUCs equal the single ``evaluate``."""
    single = launched["single"]["eval"]
    for res in launched["ranks"]:
        assert int(res[f"eval/{mesh}/batch_videos"]) == 4
        np.testing.assert_allclose(res[f"eval/{mesh}/preds"], single.preds, rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(res[f"eval/{mesh}/aucs"], [single.rec_auc, single.pr_auc],
                                   rtol=1e-12)


def test_stop_signal_on_one_rank_stops_every_rank(launched):
    """SIGTERM on rank 1 during step 2: every rank stops at step 2, and
    rank 0 alone saves that step."""
    assert [int(res["stop/step"]) for res in launched["ranks"]] == [2, 2, 2, 2]
    ckpt = launched["root"] / "spawn" / "stop_ckpt"
    assert sorted(os.listdir(ckpt)) == ["2"]


def test_store_barrier_and_blocked_imports(launched):
    """Every rank saw every rank's arrival after the barrier, and the ranks
    ran with jax, flax and the JAX package unimportable."""
    for res in launched["ranks"]:
        assert int(res["barrier/seen"]) == 4
        assert bool(res["imports_blocked"])


def test_only_rank_zero_writes_checkpoints(launched):
    returned = [bool(res["ckpt/returned"]) for res in launched["ranks"]]
    assert returned == [True, False, False, False]
    assert sorted(os.listdir(launched["root"] / "spawn" / "tp_ckpt")) == ["3", "hparams.json"]


def test_tp_checkpoint_loads_single_device_and_serves(launched):
    """The DP 2 x TP 2 checkpoint holds the single-device layout: it
    restores into a one-device state (parameters and Adam moments of the
    single 3-step run) and into ``infer.build_scorer``."""
    import argparse

    from anomaly_detection_on_video_tpu_torch import infer
    from anomaly_detection_on_video_tpu_torch.training.checkpoints import TopKCheckpointer
    from anomaly_detection_on_video_tpu_torch.training.optim import adam_with_l2
    from anomaly_detection_on_video_tpu_torch.training.runner import TrainState

    path = str(launched["root"] / "spawn" / "tp_ckpt")
    _, params = launched["single"]["mgfn/plain"]
    model = port_model("mgfn", launched["weights"])
    state = TopKCheckpointer(path).restore(TrainState(model, adam_with_l2(model.parameters())))
    assert state.step == 3
    _assert_params(state_arrays(state), params, 1e-12, 1e-12)
    _, single = port_steps("mgfn", launched["weights"])
    for p, q in zip(state.model.parameters(), single.model.parameters()):
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(state.optimizer.state[p][key].numpy(),
                                       single.optimizer.state[q][key].numpy(), rtol=1e-10,
                                       atol=1e-16)
    args = infer.build_parser().parse_args(["--outdir", str(launched["root"] / "o"),
                                            "--checkpoint", path, "--device", "cpu"])
    scorer, name = infer.build_scorer(argparse.Namespace(**vars(args)))
    assert name == "mgfn"
    for k, v in scorer.state_dict().items():
        if v.is_floating_point():
            np.testing.assert_allclose(v.double().numpy(), params[k], rtol=1e-6, atol=1e-7)


def test_tp_state_bytes_per_rank(launched):
    """Full-width Sultani on DP 2 x TP 2 after one step: each rank holds
    1/tp of the replicated state's bytes (to 1e-3), as tests/test_tp_audit.py
    holds the JAX package."""
    from anomaly_detection_on_video_tpu_torch.models import Sultani, SultaniConfig
    from anomaly_detection_on_video_tpu_torch.training.optim import adam_with_l2
    from anomaly_detection_on_video_tpu_torch.training.runner import TrainState

    model = Sultani(SultaniConfig(dropout_rate=0.0))
    state = TrainState(model, adam_with_l2(model.parameters()))
    replicated = 3 * sum(p.numel() * p.element_size() for p in model.parameters())
    for res in launched["ranks"]:
        assert abs(int(res["tp_bytes"]) / replicated - 0.5) < 1e-3
    assert state_bytes(state) == replicated // 3  # no moments before a step
