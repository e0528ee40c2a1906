"""The port's probes (``anomaly_detection_on_video_tpu_torch/scripts/``):
their command lines and the JAX probes' record names and keys.

Every probe runs on the card unless told ``--device cpu``, so asking for
the card here, where there is none, ends in ``resolve_device``'s error,
never in a CPU run. At small sizes on the CPU (the kernels' plain
versions) each probe prints the JAX probe's names with its keys.
"""

import importlib
import json

import pytest
import torch

from anomaly_detection_on_video_tpu_torch.scripts import (conv2d_probe, eval_probe,
                                                          int8_pallas_probe, int8_stage_probe,
                                                          stage_probe, stem2d_probe)

PROBES = ("int8_pallas_probe", "stage_probe", "int8_stage_probe", "conv2d_probe", "stem2d_probe",
          "int8_probe", "eval_probe", "overlap_ab")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", PROBES)
def test_cli_asks_for_the_card(name, capsys):
    """``--device cuda`` (the default) with no card: resolve_device's
    error before any record."""
    module = importlib.import_module(f"anomaly_detection_on_video_tpu_torch.scripts.{name}")
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])
    assert capsys.readouterr().out == ""


def test_int8_pallas_probe_verify_on_cpu(capsys):
    """``--verify --device cpu``: K4 and K5 (their plain versions here)
    against the float64 references, then the JAX probe's line."""
    assert int8_pallas_probe.main(["--verify", "--device", "cpu"]) == [{"verify": "ok"}]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {"verify": "ok"}


TINY_STAGES = {1: (8, 2, 1, (3, 3), (16, 4, 9, 9)), 2: (8, 2, 2, (3, 1), (32, 2, 9, 9))}
STAGE_KEYS = {"ms", "tflop", "gb", "mfu", "hbm_gbps"}
# probe -> (its run at small sizes, {record name: the JAX probe's keys})
CASES = {
    "int8_pallas_probe": (
        lambda: int8_pallas_probe.run(CPU, b=1, t=1, reps=1),
        {**{name: {"ms", "tf_per_s"} for name in (
            "A_pallas_int8_matmul", "B_pallas_int8_conv3x3_kernel_only",
            "C_pallas_int8_conv3x3_with_layout", "D_xla_conv_k133_int8", "D_xla_conv_k133_bf16")}}),
    "stage_probe": (
        lambda: stage_probe.run(CPU, batch=1, specs=TINY_STAGES, pipeline_batches=(),
                                mkn=(64, 32, 32), reps=1),
        {"stage1": STAGE_KEYS, "stage2": STAGE_KEYS, "matmul_bf16": {"us", "tflops_rate"},
         "matmul_int8": {"us", "tflops_rate"}, "conv_bf16": {"ms", "tflops_rate"},
         "conv_int8": {"ms", "tflops_rate"}}),
    "int8_stage_probe": (
        lambda: int8_stage_probe.run(
            CPU, batch=1, conv_shapes={
                "stage2_spatial_k133": ((16, 2, 8, 8), (16, 16, 1, 3, 3)),
                "stage2_temporal_k311": ((32, 2, 8, 8), (16, 32, 3, 1, 1)),
                "stem_k577": ((3, 16, 16, 16), (64, 3, 5, 7, 7))},
            specs=TINY_STAGES, reps=1, check_plain=True),
        {**{f"conv3d_{n}_{dt}": {"ms", "tflops_rate"} for n in (
            "stage2_spatial_k133", "stage2_temporal_k311", "stem_k577") for dt in ("bf16", "int8")},
         "stage1_int8": {"ms"}, "stage2_int8": {"ms"}}),
    "conv2d_probe": (
        lambda: conv2d_probe.run(CPU, batch=1, reps=1, cases={
            "s1_spatial": ("spatial", (16, 2, 9, 9), 16),
            "s2_temporal": ("temporal", (32, 2, 6, 6), 16)}),
        {f"{tag}_{form}_{dt}": {"ms", "tflops_rate"} for tag in ("s1_spatial", "s2_temporal")
         for dt in ("bf16", "int8") for form in ("3d", "2d")}),
    "stem2d_probe": (
        lambda: stem2d_probe.run(CPU, batches=(2, 3), clip=(16, 32, 32), reps=1),
        {"stem2d_vs_3d_f32": {"max_abs_err", "max_rel_to_peak"},
         "stem3d_bf16_B2": {"ms", "tflops_rate"}, "stem2d_bf16_B2": {"ms", "tflops_rate"},
         "stem3d_bf16_B3": {"ms", "tflops_rate"}}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_records_carry_the_jax_names_and_keys(name):
    """The records of a small run: the JAX probe's names in its order, each
    with the JAX probe's keys, no error record."""
    run, want = CASES[name]
    records = list(run())
    assert [r["probe"] for r in records] == list(want), records
    for record in records:
        assert "error" not in record and set(record) >= want[record["probe"]], record


def test_probe_checks_on_small_runs():
    """What phase 22 gates on, at small sizes: the int8 stages equal their
    plain versions' output (the plain versions here: equal by construction)
    with launches counted only on the card, the 2-D formulations equal to
    the 3-D ones, the float32 stem2d at the stem3d's values."""
    stages = {r["probe"]: r for r in CASES["int8_stage_probe"][0]()}
    assert stages["stage1_int8"]["expected_launches"] == {"int8_matmul": 3, "int8_conv": 4}
    assert stages["stage2_int8"]["expected_launches"] == {"int8_matmul": 4, "int8_conv": 3}
    assert all(stages[f"stage{s}_int8"]["unequal_vs_plain"] == 0 for s in (1, 2))
    assert all(stages[f"stage{s}_int8"]["launches"] == {"int8_matmul": 0, "int8_conv": 0}
               for s in (1, 2))
    convs = {r["probe"]: r for r in CASES["conv2d_probe"][0]()}
    for tag in ("s1_spatial", "s2_temporal"):
        assert convs[f"{tag}_2d_bf16"]["cosine_vs_3d"] >= 0.9999
        assert convs[f"{tag}_2d_int8"]["unequal_vs_3d"] == 0
    stem = next(CASES["stem2d_probe"][0]())
    assert stem["max_rel_to_peak"] <= 1e-5 and stem["tf32"] is False


def test_full_int8_stage_launches_match_the_main_path():
    """Stages 1-4 at the JAX specs: K4 / K5 launches 4 / 6, 7 / 6, 10 / 9
    and 6 / 4, which with the stem's K5 make the int8 main path's 27 / 26."""
    launches = [stage_probe.int8_launches(stage_probe.StageOnly.from_spec(spec))
                for spec in stage_probe.STAGE_SPECS.values()]
    assert [(n["int8_matmul"], n["int8_conv"]) for n in launches] == [(4, 6), (7, 6), (10, 9),
                                                                       (6, 4)]
    assert sum(n["int8_matmul"] for n in launches) == 27
    assert sum(n["int8_conv"] for n in launches) + 1 == 26


# the JAX eval probe's report keys
EVAL_KEYS = {"workload", "assemble_only_s", "eval_serial_s", "eval_prefetch_s",
             "device_plus_readback_est_s", "host_assembly_fraction_of_serial", "prefetch_speedup",
             "eval_clips_per_sec_serial", "eval_clips_per_sec_prefetch"}


def test_eval_probe_report_keys():
    """A narrow MGFN over 4 videos: the JAX report's keys, the assembly
    bytes of two full groups of bucket 32."""
    (report,) = eval_probe.run(CPU, n_videos=4, clips=30, batch_videos=2, dims=[16, 16, 32],
                               depths=[1, 1, 1], dim_head=8)
    assert set(report) >= EVAL_KEYS and "error" not in report
    assert report["assembled_bytes"] == 2 * 2 * 10 * 32 * 2049 * 4
