"""Timing, bounds and records on the card, shared by ``chip_smoke.py`` and
the probes of ``scripts/``.

- ``PEAK_FLOPS`` / ``HBM_BYTES_PER_S``: one H100 SXM's published dense
  peaks and memory rate (at its 700 W limit), what ``bound`` and every
  ``mfu`` divide by;
- ``cuda_ms``: device time by CUDA events after a warm-up; ``mean_ms`` is
  the same on the card and host time on the CPU (a ``--device cpu`` run
  times torch's CPU kernels, never the card);
- ``bound``: the least time the card could take for a given work, bytes
  over the memory rate or operations over the peak, whichever is longer;
- ``check_equal``, ``host_us``, ``taps_inside``: bit-equality with the
  max difference, host time per launch, the taps of a padded conv that
  read the input;
- ``guarded``: a probe section's records, or one ``{"probe": ...,
  "error": ...}`` record where it raised; ``release`` hands a section's
  cached memory back to the card;
- ``probe_cli`` (``probe_parser`` + ``print_records``): the probes' command
  line, ``--device`` only, which prints each record as a JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from typing import Callable, Iterable, List, Optional

import torch

from .device import resolve_device

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12,  # dense tensor bf16; fp32 non-tensor
              "int8": 1979e12}  # dense tensor int8 (operations per second)


def cuda_ms(fn: Callable[[], object], iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def mean_ms(fn: Callable[[], object], iters: int, device: torch.device, warmup: int = 1) -> float:
    """``cuda_ms`` on a CUDA device; on the CPU the host time of a run
    (torch's CPU kernels return with their result)."""
    if device.type == "cuda":
        return cuda_ms(fn, iters, warmup)
    for _ in range(warmup):
        fn()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - start) / iters * 1e3


def bound(bytes_moved: float, flops: float, dtype_name: str):
    """(ms, "bytes" or "operations"): ``bytes_moved`` over the memory rate
    or ``flops`` over the ``dtype_name`` peak, whichever is longer."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_equal(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """Raise unless ``got`` equals ``ref`` bit for bit; returns max |got -
    ref|, computed in float64 over slices of 2^26 values."""
    if got.is_cuda:
        torch.cuda.synchronize()
    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} against "
                             f"{ref.dtype} {tuple(ref.shape)}")
    flat_got, flat_ref, diff = got.reshape(-1), ref.reshape(-1), 0.0
    for i in range(0, flat_got.numel(), 1 << 26):
        part = flat_got[i:i + (1 << 26)].double() - flat_ref[i:i + (1 << 26)].double()
        diff = max(diff, part.abs().max().item())
    if not torch.equal(got, ref):
        bad = (got != ref).sum().item()
        raise AssertionError(f"{name}: {bad} of {ref.numel()} elements differ, max |err| {diff}")
    return diff


def host_us(fn: Callable[[], object], calls: int = 500) -> float:
    """Host time of one ``fn()`` call in microseconds: the time to enqueue
    ``calls`` launches whose device work is shorter than their launch."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - start
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def taps_inside(size_in: int, positions: int, kernel: int, stride: int, pad: int) -> int:
    """Taps of a strided, zero-padded conv along one axis that read the
    input rather than its padding, summed over output positions
    ``0 .. positions - 1``."""
    return sum(1 for o in range(positions) for k in range(kernel)
               if 0 <= o * stride - pad + k < size_in)


def device_kind(device: torch.device) -> str:
    """The card's name, or ``cpu``: what every probe record ran on."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def release(device: torch.device) -> None:
    """Return the cached blocks of a probe section's tensors to the card."""
    if device.type == "cuda":
        torch.cuda.empty_cache()


def guarded(name: str, section: Callable[[], object]) -> List[dict]:
    """The records of ``section()`` (one record or a list of them). Where
    it raises, its traceback goes to stderr and one record ``{"probe":
    name, "error": ...}`` stands in, so the probe's other sections still
    run, as the JAX probes guard theirs; a caller that gates on the
    records fails on it."""
    try:
        out = section()
    except Exception as exc:  # the probe's boundary: report and go on
        traceback.print_exc()
        return [{"probe": name, "error": repr(exc)[:500]}]
    return out if isinstance(out, list) else [out]


def probe_parser(description: str) -> argparse.ArgumentParser:
    """The probes' command line: ``--device``, ``cuda`` unless told ``cpu``."""
    parser = argparse.ArgumentParser(description=description,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def print_records(device: torch.device, records: Iterable[dict]) -> List[dict]:
    """``{"device": <name>}``, then each record as one JSON line as it
    comes. Returns them all."""
    printed = [{"device": device_kind(device)}]
    print(json.dumps(printed[0]), flush=True)
    for record in records:
        print(json.dumps(record), flush=True)
        printed.append(record)
    return printed


def probe_cli(description: str, run: Callable[[torch.device], Iterable[dict]],
              argv: Optional[List[str]] = None) -> List[dict]:
    """A probe's whole command line: parse ``--device`` (a card must be
    there unless ``cpu``), then print the records of ``run(device)``."""
    device = resolve_device(probe_parser(description).parse_args(argv).device)
    return print_records(device, run(device))
