"""The port's writer of orbax checkpoints, its databases and steps
(``utils/ocdbt.OcdbtWriter``, ``training/orbax.write_orbax_step``,
``utils/convert.train_state_to_orbax`` and the checkpointer's ``save``)
against tensorstore's ``ocdbt`` kvstore and the JAX package's own
``TopKCheckpointer.restore``; and the steps of the port's earlier
``state.pt`` format, which the checkpointer still reads.
"""

import functools
import json
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch

from anomaly_detection_on_video_tpu.models import build_model as j_build_model
from anomaly_detection_on_video_tpu.training.checkpoints import TopKCheckpointer as JCheckpointer
from anomaly_detection_on_video_tpu.training.optim import adam_with_l2 as j_adam_with_l2
from anomaly_detection_on_video_tpu.training.runner import TrainState as JTrainState
from anomaly_detection_on_video_tpu_torch import infer as t_infer
from anomaly_detection_on_video_tpu_torch.models import build_model
from anomaly_detection_on_video_tpu_torch.training.checkpoints import (
    METRICS_FILE,
    STATE_FILE,
    TopKCheckpointer,
)
from anomaly_detection_on_video_tpu_torch.training.optim import adam_with_l2
from anomaly_detection_on_video_tpu_torch.training.orbax import is_orbax_step, read_orbax_step
from anomaly_detection_on_video_tpu_torch.training.runner import TrainState
from anomaly_detection_on_video_tpu_torch.utils import ocdbt
from anomaly_detection_on_video_tpu_torch.utils.convert import (
    SCORERS_TO_FLAX,
    train_state_from_orbax,
    train_state_to_orbax,
)
from torch_orbax_fixtures import NARROW, _args, _jax_restored, _jax_state, assert_trees_bit_equal
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_state(name, seed, steps=3, step=7):
    """A narrow port ``TrainState`` of ``name`` with random weights and
    buffers after ``steps`` Adam steps on random gradients (every moment
    nonzero), at optimizer step ``step``."""
    _, model = build_model(name, **NARROW[name])
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for key, value in model.state_dict().items():
            if value.is_floating_point():
                value.copy_(torch.rand(value.shape, generator=gen) + 0.5 if "var" in key
                            else torch.randn(value.shape, generator=gen))
    state = TrainState(model, adam_with_l2(model.parameters()))
    for _ in range(steps):
        state.optimizer.zero_grad()
        loss = sum((p * torch.randn(p.shape, generator=gen)).sum() for p in model.parameters())
        loss.backward()
        state.optimizer.step()
    state.step = step
    return state


def _expected_tree(name, state):
    """The tree the JAX restore must give back, made by the family's
    ``*_state_dict_to_flax`` straight from the port's state dicts."""
    to_flax = SCORERS_TO_FLAX[name]
    variables = to_flax(state.model.state_dict())
    params = list(state.model.parameters())
    names = [n for n, _ in state.model.named_parameters()]
    moments = {key: to_flax({n: state.optimizer.state[p][key] for n, p in zip(names, params)})
               for key in ("exp_avg", "exp_avg_sq")}
    count = state.optimizer.state[params[0]]["step"].item()
    return {"params": variables["params"], "batch_stats": variables.get("batch_stats", {}),
            "opt_state": [None, None, [{"count": np.asarray(count, np.int32),
                                        "mu": moments["exp_avg"]["params"],
                                        "nu": moments["exp_avg_sq"]["params"]}, None]],
            "step": np.asarray(state.step, np.int32)}


# ----------------------------------------------------------------- OCDBT

def _items(case):
    rng = np.random.RandomState(5)

    def value(n):
        return bytes(rng.randint(0, 256, n).astype(np.uint8))

    if case == "orbax":  # about 400 keys as one step has them, values inline and indirect
        items = {}
        for i in range(200):
            name = f"opt_state.2.0.mu.backbone.stage{i % 3}_block{i % 5}.attention.w{i:03d}"
            items[f"{name}/.zarray"] = value(160)
            items[f"{name}/0"] = value(rng.choice([0, 40, 1024, 1025, 30000]))
        return items
    if case == "long_prefixes":  # keys sharing 300 bytes, values inline and indirect
        return {"k" * 300 + f"/{i:03d}": value(rng.choice([0, 40, 2000])) for i in range(120)}
    if case == "many_keys":  # ten times a step's keys in the one leaf
        return {f"key{i:05d}": value(rng.randint(0, 60)) for i in range(4000)}
    return {}  # empty


def _write_database(path, items):
    with ocdbt.OcdbtWriter(str(path)) as writer:
        for key, value in items.items():
            writer.put(key, value)
    return writer.version


def _ts_kv(path):
    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/"}).result()


@pytest.mark.parametrize("case", ["orbax", "long_prefixes", "many_keys", "empty"])
def test_written_database_reads_in_tensorstore(case, tmp_path):
    """A database ``OcdbtWriter`` makes lists and reads the same keys and
    values through tensorstore's ``ocdbt`` kvstore and ``OcdbtStore``:
    values inline, indirect (past the inline limit) and empty, about 400
    keys of an orbax step, keys with long shared prefixes, 4000 keys in
    the one leaf, and a database with no key."""
    items = _items(case)
    version = _write_database(tmp_path, items)
    kv, store = _ts_kv(tmp_path), ocdbt.OcdbtStore(str(tmp_path))
    want = sorted(k.encode() for k in items)
    assert sorted(kv.list().result()) == store.list() == want  # tensorstore lists unordered
    for key, value in items.items():
        assert kv.read(key).result().value == value == store.read(key), key
    assert store.latest == version and version.generation == 1 and version.num_keys == len(items)
    assert version.root_height == 0 and store.config.max_inline_value_bytes == 1024
    if case == "orbax":
        assert os.listdir(tmp_path / "d") == [version.root.path[2:]]


def test_writer_refuses_a_leaf_past_the_node_limit(tmp_path, monkeypatch):
    """The writer writes one leaf: one whose decoded body passes
    ``MAX_DECODED_NODE_BYTES`` raises, and leaves no manifest."""
    monkeypatch.setattr(ocdbt, "MAX_DECODED_NODE_BYTES", 2000)
    writer = ocdbt.OcdbtWriter(str(tmp_path))
    for i in range(100):
        writer.put(f"key{i:03d}", bytes(30))
    with pytest.raises(ValueError, match="passes the limit of 2000"):
        writer.close()
    assert not (tmp_path / ocdbt.MANIFEST_FILE).exists()


@pytest.mark.parametrize("victim", ["manifest", "node"])
def test_tensorstore_refuses_a_flipped_byte(victim, tmp_path):
    """One flipped byte in the manifest's or the b-tree node's body: both
    tensorstore (its zstd decoder or its CRC32C check) and the port's
    reader refuse the database."""
    version = _write_database(tmp_path, _items("orbax"))
    path, offset = ((tmp_path / ocdbt.MANIFEST_FILE, 20) if victim == "manifest"
                    else (tmp_path / version.root.path, version.root.offset + 20))
    data = bytearray(path.read_bytes())
    data[offset] ^= 0x01
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="Error decoding"):
        _ts_kv(tmp_path).list().result()
    with pytest.raises(ValueError, match="CRC32C"):
        ocdbt.OcdbtStore(str(tmp_path)).list()


def test_writer_refuses_a_key_twice_and_an_existing_database(tmp_path):
    writer = ocdbt.OcdbtWriter(str(tmp_path))
    writer.put("a", b"1")
    with pytest.raises(KeyError, match="twice"):
        writer.put(b"a", b"2")
    writer.close()
    with pytest.raises(FileExistsError):
        ocdbt.OcdbtWriter(str(tmp_path))


# ------------------------------------------------------------------ steps

@pytest.mark.parametrize("name", ["mgfn", "rtfm", "sultani"])
def test_jax_restores_a_port_step(name, tmp_path):
    """A step the port's ``save`` wrote, restored by the JAX
    ``TopKCheckpointer.restore`` into a JAX template: params, batch_stats
    (RTFM's and Sultani's empty dict), mu, nu, count and step bit-equal to
    ``*_state_dict_to_flax`` of the port's state; the JAX manager sees the
    step and its metric."""
    state = _port_state(name, seed=len(name))
    port = TopKCheckpointer(str(tmp_path))
    assert port.save(7, state, metric=0.25) == str(tmp_path / "7")
    assert is_orbax_step(str(tmp_path / "7")) and not (tmp_path / "7" / STATE_FILE).exists()
    assert sorted(os.listdir(tmp_path)) == ["7"]
    template = _jax_state(name, np.random.RandomState(0))
    restored = _jax_restored(tmp_path, template, 7)
    assert_trees_bit_equal(restored, _expected_tree(name, state))
    assert (restored["batch_stats"] == {}) == (name != "mgfn")
    ref = JCheckpointer(str(tmp_path))
    assert ref.manager.all_steps() == [7] and ref.manager.metrics(7) == {"metric": 0.25}
    assert ref.resolve_step("best") == 7


def test_jax_restores_a_port_step_saved_before_the_first_update(tmp_path):
    """A state whose optimizer has not stepped (a run's step-0 save) is
    written as a fresh optax state: zero moments, count 0; and with no
    metric, no ``metrics`` item."""
    state = _port_state("sultani", seed=1, steps=0, step=0)
    TopKCheckpointer(str(tmp_path)).save(0, state)
    restored = _jax_restored(tmp_path, _jax_state("sultani", np.random.RandomState(0)), 0)
    adam = restored["opt_state"][2][0]
    assert int(adam.count) == 0 and int(restored["step"]) == 0
    assert all(not np.any(np.asarray(a)) for a in jax.tree_util.tree_leaves((adam.mu, adam.nu)))
    assert not (tmp_path / "0" / "metrics").exists()
    assert JCheckpointer(str(tmp_path)).manager.metrics(0) is None


@pytest.mark.parametrize("name", ["mgfn", "rtfm", "sultani"])
def test_train_state_round_trips_through_orbax(name, tmp_path):
    """``train_state_from_orbax(read_orbax_step(save))`` and
    ``train_state_from_orbax(train_state_to_orbax(state))`` give back the
    state dicts bit-equal (a BatchNorm's ``num_batches_tracked``, which
    the JAX format does not hold, comes back 0)."""
    state = _port_state(name, seed=3)
    want_model, want_opt = state.state_dicts()
    TopKCheckpointer(str(tmp_path)).save(7, state)
    for tree in (train_state_to_orbax(state, name), read_orbax_step(str(tmp_path / "7"))):
        _, model = build_model(name, **NARROW[name])
        got = train_state_from_orbax(tree, name, TrainState(model, adam_with_l2(
            model.parameters())))
        got_model, got_opt = got.state_dicts()
        assert got.step == 7 and sorted(got_model) == sorted(want_model)
        for key, value in want_model.items():
            if key.endswith("num_batches_tracked"):
                assert got_model[key].item() == 0
            else:
                assert got_model[key].dtype == value.dtype and torch.equal(got_model[key],
                                                                           value), key
        assert got_opt["param_groups"] == want_opt["param_groups"]
        assert sorted(got_opt["state"]) == sorted(want_opt["state"])
        for i, moments in want_opt["state"].items():
            for key, value in moments.items():
                assert torch.equal(got_opt["state"][i][key], value), (i, key)


def test_disagreeing_adam_steps_raise(tmp_path):
    state = _port_state("sultani", seed=4)
    first = next(iter(state.model.parameters()))
    state.optimizer.state[first]["step"] += 1
    with pytest.raises(ValueError, match="Adam steps differ"):
        train_state_to_orbax(state, "sultani")
    with pytest.raises(ValueError, match="Adam steps differ"):
        TopKCheckpointer(str(tmp_path)).save(1, state)
    assert os.listdir(tmp_path) == []  # refused before anything is written


def test_save_replaces_a_step_of_either_format(tmp_path):
    """Saving a step that is on disk replaces it, whether the earlier
    port wrote it (``state.pt``) or orbax did; a leftover ``<step>.tmp``
    is neither package's step."""
    state = _port_state("sultani", seed=5)
    port = TopKCheckpointer(str(tmp_path))
    _write_legacy_step(tmp_path, 3, state, 0.5)
    (tmp_path / "4.tmp").mkdir()
    assert port.all_steps() == [3] and not port.is_orbax(3)
    port.save(3, state, 0.75)
    assert port.is_orbax(3) and sorted(os.listdir(tmp_path / "3")) == [
        "_CHECKPOINT_METADATA", "default", "metrics"]
    assert port.metrics(3) == {"metric": 0.75} and port.all_steps() == [3]
    assert JCheckpointer(str(tmp_path)).manager.all_steps() == [3]


# ------------------------------------------------- the earlier port's steps

def _write_legacy_step(directory, step, state, metric=None):
    """One step as the port's ``save`` wrote it before it wrote orbax."""
    path = os.path.join(str(directory), str(step))
    os.makedirs(path)
    model_sd, optimizer_sd = state.state_dicts()
    torch.save({"model": model_sd, "optimizer": optimizer_sd, "step": int(state.step)},
               os.path.join(path, STATE_FILE))
    if metric is not None:
        with open(os.path.join(path, METRICS_FILE), "w") as f:
            json.dump({"metric": float(metric)}, f)


def test_legacy_state_pt_steps_restore_serve_and_prune(tmp_path):
    """A directory of ``state.pt`` steps in the earlier port's layout:
    they restore (weights, moments, step), serve through
    ``infer.build_scorer``, and are pruned by the orbax policy beside the
    orbax steps that new saves add."""
    states = {s: _port_state("mgfn", seed=10 + s, step=s) for s in (1, 2, 3)}
    for s, metric in ((1, 0.9), (2, 0.1), (3, None)):
        _write_legacy_step(tmp_path, s, states[s], metric)
    with open(tmp_path / "hparams.json", "w") as f:
        json.dump({"model_name": "mgfn", "model_config": dict(NARROW["mgfn"])}, f)
    ckpt = TopKCheckpointer(str(tmp_path), top_k=2)
    assert ckpt.all_steps() == [1, 2, 3] and not any(ckpt.is_orbax(s) for s in (1, 2, 3))
    assert ckpt.resolve_step("best") == 1 and ckpt.metrics(2) == {"metric": 0.1}
    _, model = build_model("mgfn", **NARROW["mgfn"])
    got = ckpt.restore(TrainState(model, adam_with_l2(model.parameters())), step=2)
    want_model, want_opt = states[2].state_dicts()
    assert got.step == 2
    for key, value in want_model.items():
        assert torch.equal(got.model.state_dict()[key], value), key
    for i, moments in want_opt["state"].items():
        assert torch.equal(got.optimizer.state_dict()["state"][i]["exp_avg"], moments["exp_avg"])
    scorer, name = t_infer.build_scorer(_args(checkpoint=str(tmp_path), checkpoint_step="1"))
    assert name == "mgfn"
    for key, value in states[1].model.state_dict().items():
        assert torch.equal(scorer.state_dict()[key], value), key
    ckpt.save(4, states[3], 0.5)  # top 2 by metric (1, 4) plus the latest (4)
    assert ckpt.all_steps() == [1, 4] and ckpt.is_orbax(4) and not ckpt.is_orbax(1)


# ---------------------------------------------------------- full width (slow)

@pytest.mark.slow
def test_full_width_mgfn_port_step_restores_in_jax(tmp_path):
    """A full-width MGFN (28.65 M parameters) with its Adam moments, saved
    by the port and restored by the JAX checkpointer bit-equal; prints the
    save time beside ``torch.save`` of the same state dicts."""
    _, model = build_model("mgfn")
    state = TrainState(model, adam_with_l2(model.parameters()))
    gen = torch.Generator().manual_seed(0)
    state.optimizer.zero_grad()
    sum((p * torch.randn(p.shape, generator=gen)).sum() for p in model.parameters()).backward()
    state.optimizer.step()
    state.step = 1
    start = time.perf_counter()
    TopKCheckpointer(str(tmp_path / "run")).save(1, state, 0.5)
    seconds = time.perf_counter() - start
    start = time.perf_counter()
    model_sd, optimizer_sd = state.state_dicts()
    torch.save({"model": model_sd, "optimizer": optimizer_sd, "step": 1}, tmp_path / "state.pt")
    torch_seconds = time.perf_counter() - start
    _, j_model = j_build_model("mgfn")
    variables = jax.jit(functools.partial(j_model.init, train=True))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, 10, 32, 2049)))
    template = JTrainState.create(j_model, variables, j_adam_with_l2())
    restored = _jax_restored(tmp_path / "run", template, 1)
    assert_trees_bit_equal(restored, _expected_tree("mgfn", state))
    assert sum(a.size for a in jax.tree_util.tree_leaves(restored["params"])) > 28_000_000
    print(f"port save of a full-width MGFN step: {seconds:.2f} s; torch.save: "
          f"{torch_seconds:.2f} s")
    shutil.rmtree(tmp_path)
