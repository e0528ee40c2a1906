"""PyTorch port vs the JAX package: the training slice's checkpointer and
loop, and the port's ``run`` against the repository-root ``run.py`` in
both directions of the orbax handshake.

Files are written in ``tmp_path``; both packages read the same files.
"""

import argparse
import json
import os
import shutil
import signal
import types

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

import infer as j_infer
import run as j_run
from anomaly_detection_on_video_tpu.training import runner as jrunner
from anomaly_detection_on_video_tpu.training.checkpoints import TopKCheckpointer as JCheckpointer
from anomaly_detection_on_video_tpu_torch import infer as t_infer
from anomaly_detection_on_video_tpu_torch import run as t_run
from anomaly_detection_on_video_tpu_torch.data import features as tfeatures
from anomaly_detection_on_video_tpu_torch.models import MGFN, MGFNConfig, Sultani, SultaniConfig
from anomaly_detection_on_video_tpu_torch.training import VideoAnomalyDetectionRunner
from anomaly_detection_on_video_tpu_torch.training.checkpoints import TopKCheckpointer
from anomaly_detection_on_video_tpu_torch.training.optim import adam_with_l2
from anomaly_detection_on_video_tpu_torch.training.runner import TrainState
from anomaly_detection_on_video_tpu_torch.utils.convert import (
    mgfn_state_dict_from_flax,
    mgfn_state_dict_to_flax,
)
from test_torch_mgfn import randomize_norms
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker
from torch_runner_fixtures import C, NARROW_MGFN, write_features


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread keeps torch from
    contending with the other test workers' threads, as in
    tests/test_torch_train.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -------------------------------------------------------------- checkpoints

def _scorer_state(step):
    """A tiny Sultani's train state (the checkpointer saves a scorer's
    state in orbax's format)."""
    model = Sultani(SultaniConfig(channels=3, hidden_dims=(2, 2)))
    return TrainState(model, adam_with_l2(model.parameters()), step)


def test_checkpointer_retention_and_selection_match_jax(tmp_path):
    """Top-k by metric union latest, over the same save sequence as the
    JAX (orbax) checkpointer: the same steps survive every save, and
    latest / best / exact selections agree; the JAX checkpointer opened on
    the port's directory after every save sees the same steps and
    selections."""
    metrics = [0.5, None, 0.7, 0.7, 0.2, None, 0.9, 0.1, None]
    ours = TopKCheckpointer(str(tmp_path / "t"), top_k=3)
    ref = JCheckpointer(str(tmp_path / "j"), top_k=3)
    for i, metric in enumerate(metrics):
        step = (i + 1) * 2
        ours.save(step, _scorer_state(step), metric)
        ref.save(step, types.SimpleNamespace(params={"w": np.zeros(3, np.float32)},
                                             batch_stats={"m": np.zeros(1, np.float32)},
                                             opt_state={"n": np.zeros(1, np.float32)},
                                             step=np.int32(step)), metric)
        ref.wait()
        on_ours = JCheckpointer(str(tmp_path / "t"), top_k=3)
        assert ours.all_steps() == sorted(ref.manager.all_steps()) == sorted(
            on_ours.manager.all_steps()), (step, metric)
        for selector in ("latest", "best", None):
            assert ours.resolve_step(selector) == ref.resolve_step(selector) == (
                on_ours.resolve_step(selector))
    for selector in (ours.all_steps()[0], str(ours.all_steps()[-1])):
        assert ours.resolve_step(selector) == ref.resolve_step(selector)
    for ckpt in (ours, ref):
        with pytest.raises(ValueError, match="not found"):
            ckpt.resolve_step(3)
    restored = ours.restore(_scorer_state(0), "best")
    assert restored.step == ref.resolve_step("best")
    meta = {"model_name": "mgfn", "seed": 0}
    ours.write_metadata(meta)
    assert TopKCheckpointer.load_metadata(str(tmp_path / "t")) == meta


def _tiny_runner(checkpointer=None, loggers=()):
    config = MGFNConfig(dims=(16, 16, 32), depths=(1, 1, 1), dim_head=8, channels=C)
    return VideoAnomalyDetectionRunner(MGFN(config), checkpointer=checkpointer, loggers=loggers,
                                       device="cpu")


def test_resume_continues_step_and_epoch_counts(rng, tmp_path):
    """As the JAX runner: a resumed run trains only the remaining epochs,
    and one whose budget is spent trains nothing but still evaluates."""
    train, test, _, gt_path = write_features(str(tmp_path), rng)
    datasets = tfeatures.build_feature_dataset("train", local_path=train)
    valid = tfeatures.build_feature_dataset("test", local_path=test, ground_truth_path=gt_path)
    ckpt = TopKCheckpointer(str(tmp_path / "ckpt"))
    runner = _tiny_runner(ckpt)
    runner.fit(datasets, valid_dataset=valid, max_epochs=2, batch_size=2)
    assert runner.state.step == 4 and ckpt.all_steps() == [2, 4]

    def resumed():
        r = _tiny_runner(ckpt)
        r.init_state()
        r.restore(ckpt.restore(r.state))
        return r

    r = resumed()
    assert r.state.step == 4
    torch.testing.assert_close(r.state.model.state_dict(), runner.state.model.state_dict())
    assert r.fit(datasets, valid_dataset=valid, max_epochs=3, batch_size=2) is not None
    assert r.state.step == 6
    r = resumed()
    result = r.fit(datasets, valid_dataset=valid, max_epochs=3, batch_size=2)
    assert r.state.step == 6 and 0.0 <= result.rec_auc <= 1.0


def test_preemption_signal_saves_the_step_reached(rng, tmp_path):
    train, test, _, gt_path = write_features(str(tmp_path), rng)
    datasets = tfeatures.build_feature_dataset("train", local_path=train)

    class Preempt:
        """Delivers SIGTERM to fit's handler after the third step (called
        directly: a real signal would end the process if no handler were
        installed)."""

        def log(self, metrics, step):
            if "train_loss" in metrics and step == 2:
                signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)

    ckpt = TopKCheckpointer(str(tmp_path / "ckpt"))
    runner = _tiny_runner(ckpt, [Preempt()])
    previous = signal.getsignal(signal.SIGTERM)
    assert runner.fit(datasets, max_epochs=5, batch_size=2, handle_signals=("SIGTERM",)) is None
    assert signal.getsignal(signal.SIGTERM) == previous
    assert runner.state.step == 3 and ckpt.all_steps() == [2, 3]
    assert ckpt.metrics(3) is None


# ---------------------------------------------------- the slice, end to end

def test_run_matches_jax_run_py(rng, tmp_path, monkeypatch, capsys):
    """The port's run against the repository-root run.py on one feature
    directory and ground truth: 2 epochs, eval every epoch, no shuffle, no
    selection dropout, the same initial weights (randomized norms, injected
    into both runners: the two frameworks draw different initial weights,
    and identity norms tie the top-k). Per-step losses, AUCs and
    hparams.json agree, and eval_only from the port's checkpoint repeats
    its last AUCs. Then the JAX run's orbax directory: ``trainer.resume``
    of both CLIs (each on a copy) takes two more epochs from step 4 with
    equal steps, losses and AUCs, keeping the JAX steps (fault 8: the port
    restarted from step 0 and replaced them); the port's restored Adam
    state is bit-equal to optax's, relayouted; ``eval_only`` of both agrees."""
    train, test, _, gt_path = write_features(str(tmp_path), rng)
    common = ["runner=mgfn", f"data.train_path={train}", f"data.test_path={test}",
              f"data.ground_truth_path={gt_path}", "data.batch_size=2", "trainer.max_epochs=2",
              "data.num_workers=0"] + NARROW_MGFN
    captured = {}
    j_init = jrunner.VideoAnomalyDetectionRunner.init_state

    def jax_init(self, example):
        state = j_init(self, example)
        variables = randomize_norms({"params": state.params, "batch_stats": state.batch_stats},
                                    np.random.RandomState(5))
        captured["sd"] = mgfn_state_dict_from_flax(variables)
        self.state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                                   batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                                      variables["batch_stats"]))
        return self.state

    monkeypatch.setattr(jrunner.VideoAnomalyDetectionRunner, "init_state", jax_init)
    j_run.main(common + ["trainer.data_parallel=false", f"trainer.log_path={tmp_path}/j.jsonl",
                         f"trainer.checkpoint.dirpath={tmp_path}/ck_j"])
    t_init = VideoAnomalyDetectionRunner.init_state

    def port_init(self):
        state = t_init(self)
        state.model.load_state_dict(captured["sd"])
        return state

    monkeypatch.setattr(VideoAnomalyDetectionRunner, "init_state", port_init)
    t_run.main(common + ["device=cpu", f"trainer.log_path={tmp_path}/t.jsonl",
                         f"trainer.checkpoint.dirpath={tmp_path}/ck_t"])

    def records(name):
        with open(tmp_path / name) as f:
            return [json.loads(line) for line in f]

    ref, got = records("j.jsonl"), records("t.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in ref] == [0, 1, 2, 2, 3, 4]
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for key in ("train_loss", "train_loss_epoch"):
            if key in r:
                np.testing.assert_allclose(g[key], r[key], rtol=1e-4)
        for key in ("valid/rec_auc", "valid/pr_auc"):
            if key in r:
                np.testing.assert_allclose(g[key], r[key], atol=1e-4)
    assert (TopKCheckpointer.load_metadata(str(tmp_path / "ck_t"))
            == JCheckpointer.load_metadata(str(tmp_path / "ck_j")))
    capsys.readouterr()
    t_run.main(common + ["device=cpu", "trainer.eval_only=true", "trainer.log_path=",
                         f"trainer.checkpoint.dirpath={tmp_path}/ck_t"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["step"] == 4
    assert line["valid/rec_auc"] == got[-1]["valid/rec_auc"]
    assert line["valid/pr_auc"] == got[-1]["valid/pr_auc"]

    # the JAX run's orbax directory: resumed by both CLIs for two more
    # epochs (each on a copy), and evaluated by both
    for tag in ("resume_t", "resume_j"):
        shutil.copytree(tmp_path / "ck_j", tmp_path / tag)
    resume = common + ["trainer.max_epochs=4", "trainer.resume=true"]
    t_run.main(resume + ["device=cpu", f"trainer.log_path={tmp_path}/t_resume.jsonl",
                         f"trainer.checkpoint.dirpath={tmp_path}/resume_t"])
    assert "resumed from step 4" in capsys.readouterr().out
    j_run.main(resume + ["trainer.data_parallel=false", f"trainer.log_path={tmp_path}/j_resume.jsonl",
                         f"trainer.checkpoint.dirpath={tmp_path}/resume_j"])
    ref, got = records("j_resume.jsonl"), records("t_resume.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in ref] == [4, 5, 6, 6, 7, 8]
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for key in ("train_loss", "train_loss_epoch"):
            if key in r:
                np.testing.assert_allclose(g[key], r[key], rtol=1e-4)
        for key in ("valid/rec_auc", "valid/pr_auc"):
            if key in r:
                np.testing.assert_allclose(g[key], r[key], atol=1e-4)
    assert sorted(os.listdir(tmp_path / "resume_t")) == sorted(os.listdir(tmp_path / "resume_j")) \
        == ["2", "4", "6", "8", "hparams.json"]
    resumed = TopKCheckpointer(str(tmp_path / "resume_t"))
    assert [resumed.is_orbax(s) for s in resumed.all_steps()] == [True, True, True, True]

    # the restored optimizer state: exp_avg, exp_avg_sq and step bit-equal
    # to optax's mu, nu and count (orbax's own read), relayouted
    raw = ocp.PyTreeCheckpointer().restore(str(tmp_path / "ck_j" / "4" / "default"))
    adam = raw["opt_state"][2][0]
    from_raw = {k: mgfn_state_dict_from_flax({"params": adam[k], "batch_stats": raw["batch_stats"]})
                for k in ("mu", "nu")}
    model = MGFN(MGFNConfig(dims=(16, 16, 32), depths=(1, 1, 1), dim_head=8, channels=C,
                            dropout_rate=0.0))
    state = TopKCheckpointer(str(tmp_path / "ck_j")).restore(
        TrainState(model, adam_with_l2(model.parameters())), step=4)
    assert state.step == 4 == int(raw["step"])
    optimizer = state.optimizer.state_dict()["state"]
    for i, (key, _) in enumerate(state.model.named_parameters()):
        assert torch.equal(optimizer[i]["exp_avg"], from_raw["mu"][key]), key
        assert torch.equal(optimizer[i]["exp_avg_sq"], from_raw["nu"][key]), key
        assert optimizer[i]["step"].item() == float(adam["count"]) == 4.0

    for main, extra in ((t_run.main, ["device=cpu"]), (j_run.main, ["trainer.data_parallel=false"])):
        main(common + extra + ["trainer.eval_only=true", "trainer.log_path=",
                               f"trainer.checkpoint.dirpath={tmp_path}/ck_j"])
    port_line, jax_line = (json.loads(text) for text in
                           capsys.readouterr().out.strip().splitlines()[-2:])
    assert port_line["step"] == jax_line["step"] == 4
    for key in ("valid/rec_auc", "valid/pr_auc"):
        np.testing.assert_allclose(port_line[key], jax_line[key], atol=1e-4)


def test_port_written_run_resumes_serves_and_evaluates_in_jax(rng, tmp_path, monkeypatch,
                                                              capsys):
    """The CLI handshake the other way: the port's ``run`` trains 2 epochs
    into a fresh directory (orbax steps, from an init with random norms:
    identity norms tie the top-k). The root ``run.py`` and the port's
    ``run`` each resume a copy for 2 more epochs: the same steps, losses
    within 1e-4 relative, the same files left. The root ``infer.py``'s
    ``build_scorer`` of the port-written directory scores as the port's,
    within 1e-5, and the JAX ``eval_only`` equals the port's."""
    train, test, _, gt_path = write_features(str(tmp_path), rng)
    common = ["runner=mgfn", f"data.train_path={train}", f"data.test_path={test}",
              f"data.ground_truth_path={gt_path}", "data.batch_size=2", "trainer.max_epochs=2",
              "data.num_workers=0"] + NARROW_MGFN
    t_init = VideoAnomalyDetectionRunner.init_state

    def port_init(self):
        state = t_init(self)
        variables = randomize_norms(mgfn_state_dict_to_flax(state.model.state_dict()),
                                    np.random.RandomState(5))
        state.model.load_state_dict(mgfn_state_dict_from_flax(variables))
        return state

    monkeypatch.setattr(VideoAnomalyDetectionRunner, "init_state", port_init)
    ck = tmp_path / "ck"
    t_run.main(common + ["device=cpu", f"trainer.log_path={tmp_path}/t.jsonl",
                         f"trainer.checkpoint.dirpath={ck}"])
    assert TopKCheckpointer(str(ck)).all_steps() == [2, 4]
    assert not list(ck.glob("*/state.pt"))
    for tag in ("resume_t", "resume_j"):
        shutil.copytree(ck, tmp_path / tag)
    resume = common + ["trainer.max_epochs=4", "trainer.resume=true"]
    capsys.readouterr()
    j_run.main(resume + ["trainer.data_parallel=false", f"trainer.log_path={tmp_path}/j_r.jsonl",
                         f"trainer.checkpoint.dirpath={tmp_path}/resume_j"])
    t_run.main(resume + ["device=cpu", f"trainer.log_path={tmp_path}/t_r.jsonl",
                         f"trainer.checkpoint.dirpath={tmp_path}/resume_t"])
    assert "resumed from step 4" in capsys.readouterr().out

    def records(name):
        with open(tmp_path / name) as f:
            return [json.loads(line) for line in f]

    ref, got = records("j_r.jsonl"), records("t_r.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in ref] == [4, 5, 6, 6, 7, 8]
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for key in ("train_loss", "train_loss_epoch"):
            if key in r:
                np.testing.assert_allclose(g[key], r[key], rtol=1e-4)
        for key in ("valid/rec_auc", "valid/pr_auc"):
            if key in r:
                np.testing.assert_allclose(g[key], r[key], atol=1e-4)
    assert sorted(os.listdir(tmp_path / "resume_t")) == sorted(os.listdir(tmp_path / "resume_j")) \
        == ["2", "4", "6", "8", "hparams.json"]

    feats = (np.abs(rng.randn(9, 10, C)) * 0.5).astype(np.float32)
    for step in ("latest", "best", "2"):
        args = argparse.Namespace(model=None, model_config=None, checkpoint=str(ck),
                                  torch_weights=None, official=False, i3d_weights=None,
                                  checkpoint_step=step, device="cpu")
        apply_fn, variables, eval_step, j_name, _ = j_infer.build_scorer(args)
        scorer, t_name = t_infer.build_scorer(args)
        assert j_name == t_name == "mgfn"
        np.testing.assert_allclose(t_infer.score_features(feats, scorer),
                                   j_infer.score_features(feats, apply_fn, variables, eval_step),
                                   atol=1e-5, rtol=1e-5)

    for main, extra in ((t_run.main, ["device=cpu"]), (j_run.main, ["trainer.data_parallel=false"])):
        main(common + extra + ["trainer.eval_only=true", "trainer.log_path=",
                               f"trainer.checkpoint.dirpath={ck}"])
    port_line, jax_line = (json.loads(text) for text in
                           capsys.readouterr().out.strip().splitlines()[-2:])
    assert port_line["step"] == jax_line["step"] == 4
    for key in ("valid/rec_auc", "valid/pr_auc"):
        np.testing.assert_allclose(port_line[key], jax_line[key], atol=1e-4)
