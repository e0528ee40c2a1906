"""The port's user tools (``anomaly_detection_on_video_tpu_torch/scripts``)
against the JAX package's ``scripts/``, on the CPU: ``operating_point``'s
JSON, ``convert_checkpoint``'s files for every kind forward and every legal
kind ``--reverse`` (bit-equal, and byte-equal), the ``*_state_dict_to_flax``
inverses, ``int8_e2e``'s host functions and ``tp_audit``'s audit.

The training tools (``demo``, ``convergence_bench``, ``int8_e2e.run_seed``)
are in tests/test_torch_scripts_train.py. The JAX scripts are loaded from
their files under module names of their own, so the port's tools and the
other tests' ``sys.path`` imports of ``scripts/`` do not collide.
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization as flax_serialization

from anomaly_detection_on_video_tpu.ops import metrics as jmetrics
from anomaly_detection_on_video_tpu.utils.serialization import load_variables as j_load_variables
from anomaly_detection_on_video_tpu_torch.models import build_model
from anomaly_detection_on_video_tpu_torch.models import i3d as ti3d
from anomaly_detection_on_video_tpu_torch.scripts import convert_checkpoint, int8_e2e
from anomaly_detection_on_video_tpu_torch.scripts import operating_point, tp_audit
from anomaly_detection_on_video_tpu_torch.utils import convert as tconvert
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(name):
    """The JAX package's ``scripts/<name>.py`` as a module of its own name."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread, as in tests/test_torch_train.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------- operating_point

def _write_scores(root, stem, frame_scores):
    path = root / "scores" / f"{stem}_scores.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps({"video": f"{stem}.avi", "n_clips": len(frame_scores) // 16 or 1,
                                "frame_scores": frame_scores}))


def _separable(root):
    _write_scores(root, "Abuse001_x264", [0.9, 0.8, 0.1, 0.2])
    _write_scores(root, "Normal_Videos_001_x264", [0.3, 0.7])
    return {"Abuse001_x264": [1.0, 1.0, 0.0, 0.0], "Normal_Videos_001_x264": [0.0, 1.0],
            "unscored_video": [1.0]}, ["--per-video"]


def _noisy(root):
    rng = np.random.RandomState(0)
    labels = (rng.rand(200) < 0.3).astype(float)
    scores = np.clip(labels * 0.4 + rng.rand(200) * 0.6, 0, 1)
    _write_scores(root, "Mix001_x264", scores.round(6).tolist())
    return {"Mix001_x264": labels.tolist()}, ["--target-fpr", "0.05"]


def _per_class(root):
    videos = {"Abuse001_x264": [0.9, 0.8, 0.1, 0.2], "Shooting002_x264": [0.7, 0.1, 0.6, 0.3],
              "Normal_Videos_001_x264": [0.3, 0.7, 0.2, 0.1]}
    for stem, frames in videos.items():
        _write_scores(root, stem, frames)
    return {"Abuse001_x264": [1.0, 1.0, 0.0, 0.0], "Shooting002_x264": [1.0, 0.0, 1.0, 0.0],
            "Normal_Videos_001_x264": [0.0, 0.0, 0.0, 0.0]}, ["--per-class"]


@pytest.mark.parametrize("case", [_separable, _noisy, _per_class])
def test_operating_point_json_equals_the_jax_script(case, tmp_path, capsys):
    """The three cases of tests/test_operating_point.py: the port's JSON
    line equals the JAX script's, key for key and value for value."""
    gt, flags = case(tmp_path)
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    argv = ["--scores", str(tmp_path / "scores"), "--gt", str(tmp_path / "gt.json"), *flags]
    jax_script("operating_point").main(argv)
    want = capsys.readouterr().out.strip()
    operating_point.main(argv)
    got = capsys.readouterr().out.strip()
    assert got == want
    assert json.loads(got)["videos"] >= 1


# ---------------------------------------------------- convert_checkpoint

def _randomized(module, seed):
    """Every float tensor of the state dict random (variances positive)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, value in module.state_dict().items():
            if value.is_floating_point():
                noise = torch.rand(value.shape, generator=gen)
                value.copy_(noise + 0.5 if name.endswith("running_var") else noise * 0.4 - 0.2)
    return {k: v.clone() for k, v in module.state_dict().items()}


I3D_STAGES = ((8, 1, 1, (3,), (1,)), (8, 2, 2, (3, 1), (1, 1)), (16, 2, 2, (1, 3), (1, 1)),
              (16, 1, 2, (1,), (1,)))
MGFN_TINY = dict(dims=(16, 16, 32), depths=(1, 1, 1), dim_head=8, channels=24)


def _official_mgfn(hf):
    """The official MGFN release's keys of an HF-named state dict (the
    inverse of ``mgfn_state_dict_from_official``'s remap)."""
    out = {}
    ffn = {"layer_norm": "0", "in_conv": "1", "out_conv": "4"}
    for key, value in hf.items():
        parts = key.split(".")
        if parts[:2] == ["backbone", "amplifier"]:
            out[".".join(parts[2:])] = value
        elif parts[0] == "layer_norm":
            out[f"to_logits.0.{parts[1]}"] = value
        elif parts[0] == "fc":
            out[key] = value
        else:
            s, d, module = parts[2], parts[3], parts[4]
            if module in ("layer_norm", "conv"):  # an intermediate, at block index 3
                out[f"stages.{s}.1.{0 if module == 'layer_norm' else 1}.{parts[-1]}"] = value
            elif module == "scc":
                out[f"stages.{s}.0.layers.{d}.0.{parts[-1]}"] = value
            elif module == "attention":
                out[f"stages.{s}.0.layers.{d}.1.{parts[5]}.{parts[-1]}"] = value
            else:
                out[f"stages.{s}.0.layers.{d}.2.{ffn[parts[5]]}.{parts[-1]}"] = value
    return out


def _source(kind):
    """A torch state dict of ``kind``'s layout at a narrow width, random,
    with the keys the JAX converter ignores (an I3D head, a Sultani extra)
    or folds (an RTFM BatchNorm)."""
    if kind == "i3d":
        sd = _randomized(ti3d.I3DResNet(I3D_STAGES[:3], nonlocal_stages=(1, 2)), 1)
        return dict(sd, **{"fc.weight": torch.zeros(5, 64), "fc.bias": torch.zeros(5)})
    if kind == "i3d-8x8":
        sd = tconvert.i3d_state_dict_to_pytorchvideo(_randomized(ti3d.I3DResNet(I3D_STAGES), 2))
        return {"model_state": dict(sd, **{"blocks.6.proj.weight": torch.zeros(5, 64)})}
    if kind == "mgfn-hf":
        return _randomized(build_model("mgfn", **MGFN_TINY)[1], 3)
    if kind == "mgfn-official":
        # depths of 3: the official remap puts every intermediate at block index 3
        model = build_model("mgfn", **dict(MGFN_TINY, depths=(3, 3, 1)))[1]
        return _official_mgfn(_randomized(model, 4))
    if kind == "rtfm":
        sd = _randomized(build_model("rtfm", channels=64, hidden_dims=(32, 16))[1], 5)
        # the official non_local.W's BatchNorm, which the converters fold
        bn = torch.nn.BatchNorm1d(sd["Aggregate.non_local.W.0.weight"].shape[0])
        return dict(sd, **{f"Aggregate.non_local.W.1.{k}": v
                           for k, v in _randomized(bn, 6).items()})
    sd = _randomized(build_model("sultani", channels=64, hidden_dims=(32, 16))[1], 7)
    return dict(sd, extra_buffer=torch.zeros(3))


def _leaves(tree, prefix=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], prefix + (key,))
        else:
            yield prefix + (key,), tree[key]


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """kind -> (source .pt, the JAX script's .msgpack, the port's)."""
    root = tmp_path_factory.mktemp("convert")
    j_convert = jax_script("convert_checkpoint")
    out = {}
    for kind in convert_checkpoint.KINDS:
        src = str(root / f"{kind}.pt")
        torch.save(_source(kind), src)
        want, got = str(root / f"{kind}_jax.msgpack"), str(root / f"{kind}_port.msgpack")
        j_convert.main(["--kind", kind, src, want])
        convert_checkpoint.main(["--kind", kind, src, got])
        out[kind] = (src, want, got)
    return out


@pytest.mark.parametrize("kind", convert_checkpoint.KINDS)
def test_convert_forward_equals_the_jax_script(kind, converted):
    """Every kind: the port's ``.msgpack``, read back by the JAX package's
    ``load_variables``, has the JAX script's key tree and bit-equal arrays
    (dtype, shape, values), and the two files are byte-equal."""
    _, want, got = converted[kind]
    want_tree, got_tree = dict(_leaves(j_load_variables(want))), dict(_leaves(j_load_variables(got)))
    assert sorted(got_tree) == sorted(want_tree)
    for path, value in want_tree.items():
        mine = np.asarray(got_tree[path])
        assert mine.dtype == np.asarray(value).dtype and mine.shape == np.asarray(value).shape
        np.testing.assert_array_equal(mine, value, err_msg="/".join(path))
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("kind", [k for k in convert_checkpoint.KINDS if k != "mgfn-official"])
def test_convert_reverse_equals_the_jax_script(kind, converted, tmp_path):
    """Every legal ``--reverse``: the port's ``.pt`` holds the JAX script's
    keys in its order, its tensors equal in dtype, shape and value, and
    the round trip gives back every source tensor (``num_batches_tracked``
    comes back 0: flax keeps no such count). The files are not byte-equal:
    the JAX script's ``np.ascontiguousarray`` gives that 0-d count shape
    (1,) where the port keeps the BatchNorm's shape, () (``load_state_dict``
    takes both), and numpy views record other strides for size-1
    dimensions (a (1, n) kernel), which ``torch.save`` writes."""
    src, msgpack, _ = converted[kind]
    want, got = str(tmp_path / "jax.pt"), str(tmp_path / "port.pt")
    jax_script("convert_checkpoint").main(["--kind", kind, "--reverse", msgpack, want])
    convert_checkpoint.main(["--kind", kind, "--reverse", msgpack, got])
    want_sd, got_sd = torch.load(want), torch.load(got)
    assert list(got_sd) == list(want_sd)
    for key, value in want_sd.items():
        mine = got_sd[key]
        assert mine.dtype == value.dtype and mine.is_contiguous(), key
        if key.endswith("num_batches_tracked"):
            assert (mine.shape, value.shape) == (torch.Size([]), torch.Size([1])), key
            mine = mine.reshape(1)
        assert torch.equal(mine, value), key
    source = convert_checkpoint.load_torch_state_dict(src)
    if kind == "rtfm":  # the source's BatchNorm is folded: compare with the fold
        source = tconvert.rtfm_state_dict_from_official(source)
    for key, value in got_sd.items():
        if key.endswith("num_batches_tracked"):
            assert int(value) == 0
        else:
            assert torch.equal(value, source[key]), key


def test_convert_refuses_official_mgfn_reverse_and_unknown_mgfn_keys(converted, tmp_path):
    _, msgpack, _ = converted["mgfn-official"]
    with pytest.raises(SystemExit, match="mgfn-official"):
        convert_checkpoint.main(["--kind", "mgfn-official", "--reverse", msgpack,
                                 str(tmp_path / "x.pt")])
    bad = str(tmp_path / "bad.pt")
    torch.save(dict(_source("mgfn-hf"), **{"backbone.unknown.weight": torch.zeros(2)}), bad)
    with pytest.raises(KeyError, match="backbone.unknown.weight"):
        convert_checkpoint.main(["--kind", "mgfn-hf", bad, str(tmp_path / "bad.msgpack")])


def test_convert_reads_a_port_run_checkpoint(tmp_path):
    """A ``state.pt`` of the port's ``run`` (model, optimizer, step) converts
    as its model's state dict."""
    sd = _source("sultani")
    sd.pop("extra_buffer")
    torch.save({"model": sd, "optimizer": {}, "step": 3}, tmp_path / "state.pt")
    convert_checkpoint.main(["--kind", "sultani", str(tmp_path / "state.pt"),
                             str(tmp_path / "s.msgpack")])
    back = tconvert.sultani_state_dict_from_flax(j_load_variables(str(tmp_path / "s.msgpack")))
    assert sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


# ------------------------------------------------------ the to_flax inverses

@pytest.mark.parametrize("kind", ["i3d", "mgfn", "rtfm", "sultani"])
def test_to_flax_inverts_from_flax_exactly(kind):
    """flax -> port -> flax gives every leaf back bit for bit (the flax
    trees of the JAX package's ``convert_*_state_dict`` of a random narrow
    model: the layout its flax modules hold), and port -> flax -> port
    every tensor."""
    from anomaly_detection_on_video_tpu.utils import convert as jconvert

    from_flax = getattr(tconvert, f"{kind}_state_dict_from_flax")
    to_flax = getattr(tconvert, f"{kind}_state_dict_to_flax")
    if kind == "i3d":
        model = ti3d.I3DResNet(I3D_STAGES[:3], nonlocal_stages=(1, 2))
        variables = jconvert.convert_i3res50_state_dict(_randomized(model, 8))
    else:
        cfg = MGFN_TINY if kind == "mgfn" else dict(channels=64, hidden_dims=(32, 16))
        converter = getattr(jconvert, f"convert_{kind}_state_dict")
        variables = converter(_randomized(build_model(kind, **cfg)[1], 9))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    state_dict = from_flax(variables)
    back = dict(_leaves(to_flax(state_dict)))
    want = dict(_leaves(flax_serialization.to_state_dict(variables)))
    assert sorted(back) == sorted(want)
    for path, value in want.items():
        assert back[path].dtype == value.dtype
        np.testing.assert_array_equal(back[path], value, err_msg="/".join(path))
    again = from_flax(to_flax(state_dict))
    assert list(again) == list(state_dict)
    assert all(torch.equal(again[k], v) for k, v in state_dict.items())
    with pytest.raises(KeyError, match="not_a_key"):
        to_flax(dict(state_dict, not_a_key=torch.zeros(1)))


# ------------------------------------------------------------- int8_e2e

@pytest.fixture(scope="module")
def j_int8():
    return jax_script("int8_e2e")


def test_int8_e2e_synth_video_and_gt_are_bit_equal(j_int8):
    for anomalous, seed in ((False, 10), (True, 1011)):
        np.testing.assert_array_equal(int8_e2e.synth_video(40, anomalous, seed),
                                      j_int8.synth_video(40, anomalous, seed))
    for args in ((40, 2, True), (256, 16, True), (256, 16, False), (100, 3, True)):
        assert int8_e2e.gt_frames(*args) == j_int8.gt_frames(*args)


def _scores_and_gt(seed):
    rng = np.random.RandomState(seed)
    names = [f"{'Abuse' if i % 2 else 'Normal_Videos'}{i:03d}_x264" for i in range(6)]
    a = {n: rng.rand(4).astype(np.float32) for n in names}
    b = {n: np.clip(a[n] + rng.randn(4).astype(np.float32) * 0.1, 0, 1) for n in names}
    gt = {n: int8_e2e.gt_frames(64, 4, i % 2 == 1) for i, n in enumerate(names)}
    return a, b, gt


def test_int8_e2e_auc_over_is_bit_equal(j_int8):
    a, _, gt = _scores_and_gt(0)
    assert int8_e2e.auc_over(a, gt) == j_int8.auc_over(a, gt)
    assert int8_e2e.auc_over(a, gt) == jmetrics.roc_auc(
        np.concatenate([gt[n] for n in sorted(a)]),
        np.concatenate([np.repeat(a[n], 16) for n in sorted(a)]))


def test_int8_e2e_compare_and_aggregate_are_bit_equal(j_int8):
    runs = []
    for seed in (1, 2):
        a, b, gt = _scores_and_gt(seed)
        got, want = int8_e2e.compare(a, b, gt, "tencrop"), j_int8.compare(a, b, gt, "tencrop")
        assert json.dumps(got) == json.dumps(want)
        runs.append({"tencrop": got, "center_serving": int8_e2e.compare(b, a, gt, "center"),
                     "protocol_cost_bf16": {"auc_delta_ten_minus_center": got["auc_delta"] - 0.5}})
    assert int8_e2e._agg([r["tencrop"]["auc_delta"] for r in runs]) == j_int8._agg(
        [r["tencrop"]["auc_delta"] for r in runs])
    assert set(int8_e2e.aggregate(runs)) == {
        "int8_auc_delta_tencrop", "int8_auc_delta_center", "int8_max_score_delta_tencrop",
        "int8_max_score_delta_center", "protocol_auc_cost_center_vs_tencrop_bf16",
        "auc_bf16_tencrop", "auc_bf16_center"}


# ------------------------------------------------------------- tp_audit

@pytest.mark.parametrize("tp", [2, 4])
def test_tp_audit_sultani_equals_the_jax_audit(tp):
    """The byte figures equal the JAX audit's, and the split is ideal (the
    JAX test's gates). The leaf share differs by what the states hold:
    torch's Adam keeps a step per parameter (6), where the JAX state holds
    one step and one count; the same 15 leaves are split in both."""
    os.environ["_TP_AUDIT_BOOTSTRAPPED"] = "1"  # conftest already forced the CPU
    want = jax_script("tp_audit").audit_family("sultani", tp)
    got = tp_audit.audit_family("sultani", tp)
    for key in ("family", "tp", "total_mib", "sharded_bytes_frac", "per_device_mib",
                "memory_vs_replicated"):
        assert got[key] == want[key], key
    assert [(e["shape"], e["kib"]) for e in got["largest_replicated"]] == [
        (e["shape"], e["kib"]) for e in want["largest_replicated"]]
    assert (want["sharded_leaf_frac"], got["sharded_leaf_frac"]) == (round(15 / 20, 4),
                                                                      round(15 / 24, 4))
    assert got["sharded_bytes_frac"] >= 0.999
    assert abs(got["memory_vs_replicated"] - 1.0 / tp) < 1e-3


def test_tp_audit_mgfn_keeps_batchnorm_statistics_whole():
    """MGFN: the parameters and moments split as in the JAX audit, but the
    port's ``ShardedParameters`` keeps the focus blocks' BatchNorm
    statistics whole, so they lead the replicated leaves."""
    got = tp_audit.audit_family("mgfn", 2)
    assert 0.999 <= got["sharded_bytes_frac"] < 1.0
    assert all("running_" in e["leaf"] for e in got["largest_replicated"])
    assert tp_audit.mesh_shapes(8) == [(8, 1), (4, 2), (2, 4)]
    assert tp_audit.mesh_shapes(1) == [(1, 1), (1, 2), (1, 4)]
    skipped = tp_audit.time_mgfn_step((1, 2), device="cpu", ranks=1)
    assert skipped == {"mesh": {"data": 1, "model": 2}, "skipped": "needs 2 ranks; 1 ranks"}


def test_launch_log_appends_each_process_counts_at_exit(tmp_path):
    """``ANOMALY_TORCH_LAUNCH_LOG``: a process that imported the kernels
    appends one line at exit, its argv and launch counts (how the card's
    smoke reads the launches of the tools' child processes)."""
    import subprocess
    import sys

    from anomaly_detection_on_video_tpu_torch.ops import kernels

    log = tmp_path / "launches.jsonl"
    log.write_text('{"earlier": "process"}\n')
    env = dict(os.environ, PYTHONPATH=REPO, **{kernels.LAUNCH_LOG_ENV: str(log)})
    subprocess.run([sys.executable, "-c", "import anomaly_detection_on_video_tpu_torch.ops.kernels",
                    "tag"], env=env, check=True, timeout=300)
    records = [json.loads(line) for line in log.read_text().splitlines()]
    assert len(records) == 2 and records[1]["argv"] == ["-c", "tag"]
    assert records[1]["launches"] == {w.__name__: 0 for w in kernels.WRAPPERS}
