"""The int8 lever at the stage-2 bottleneck shape on the card (the port's
counterpart of ``scripts/int8_pallas_probe.py``).

The JAX probe asked whether a hand-written int8 Pallas conv beats XLA's
int8 3-D conv at B = 240, T = 2, 28 x 28, 128 planes (the k(1,3,3)
workhorse of stage 2). Its two Pallas kernels are the port's K4 and K5, so
on the card each probe times them, under the JAX probe's names and keys:

  A. ``probe_raw_matmul``: K4 (``ops/kernels/int8_matmul.py``) at the JAX
     kernel's (B*T*784, 512) x (512, 256) int8 -> int32 product;
  B. ``probe_conv_kernel``: K5 (``ops/kernels/int8_conv.py``), the 3x3
     conv with its int8 requantize epilogue, on channels-last int8 planes;
  C. ``probe_conv_integrated``: B as the int8 model runs it, a bf16
     channels-last activation quantized by a static scale, K5, its bf16
     dequantize epilogue (the port's layout is channels last throughout,
     so no relayout is timed, unlike the TPU's channels-first planes);
  D. ``probe_xla_baselines``: the library call at the same shape, bf16
     cuDNN ``F.conv3d``; there is no int8 one (torch has no int8 conv on
     CUDA), which its int8 record says.

``verify_kernel_correctness`` (``--verify``) holds K4 and K5 bit-equal to
their plain versions, and K5 to a float64 ``F.conv2d`` under the JAX
probe's row order (weight row ``tap * C + c_in``, taps (kh, kw) row-major).
``check_int8_probe_shapes`` is the same check at the probe's full shapes
and at K4's edge shapes, with times (``chip_smoke.py`` phase 4).

    python -m anomaly_detection_on_video_tpu_torch.scripts.int8_pallas_probe \\
        [--verify] [--device cpu]
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import torch
import torch.nn.functional as F

from ..ops.kernels import int8_conv, int8_conv_plain, int8_matmul, int8_matmul_plain
from ..ops.quant import quantize_activation
from ..utils.device import resolve_device
from ..utils.measure import (bound, check_equal, cuda_ms, guarded, host_us, mean_ms, print_records,
                             probe_parser, taps_inside)

H = W = 28
F_ = H * W  # 784 flat spatial positions (the JAX probe's F)
PLANES = 128
B, T = 240, 2
K3X3 = ((1, 3, 3), (1, 1, 1), (0, 1, 1))  # K5's (kernel, stride, padding) of the 3x3 conv


def _randint(gen: torch.Generator, low: int, high: int, shape, device) -> torch.Tensor:
    """int8 values in [low, high), drawn on the CPU from ``gen`` (the same
    values on any device)."""
    return torch.randint(low, high, shape, generator=gen, dtype=torch.int8).to(device)


def _route(device: torch.device, kernel: str) -> str:
    return kernel if device.type == "cuda" else f"{kernel}'s plain version (CPU)"


def _rate(flops: float, ms: float) -> float:
    return round(flops / ms / 1e9, 1)  # TFLOP/s from ms


def probe_raw_matmul(device: torch.device, b: int = B, t: int = T, reps: int = 20) -> dict:
    """A: K4 at the JAX kernel's contraction, (b*t*784, 512) x (256, 512)^T
    -> int32."""
    k, n, m = 512, 256, b * t * F_
    gen = torch.Generator().manual_seed(0)
    a, w = _randint(gen, -127, 127, (m, k), device), _randint(gen, -127, 127, (n, k), device)
    ms = mean_ms(lambda: int8_matmul(a, w), reps, device)
    flops = 2.0 * m * k * n
    bound_ms, bound_by = bound(m * k + n * k + 4 * m * n, flops, "int8")
    return {"probe": "A_pallas_int8_matmul", "ms": round(ms, 4), "tf_per_s": _rate(flops, ms),
            "kernel": _route(device, "K4 int8_matmul"), "bound_ms": round(bound_ms, 4),
            "bound_by": bound_by}


def conv_operands(gen: torch.Generator, device):
    """K5's operands of probes B and C: (Cout, 9 * Cin) int8 weights in
    [-5, 5) (row ``(kh, kw, c_in)``, the transpose of the JAX probe's
    ``tap * C + c_in`` rows) and a 1e-3 scale per output channel."""
    w = _randint(gen, -5, 5, (PLANES, 9 * PLANES), device)
    return w, torch.full((PLANES,), 1e-3, dtype=torch.float32, device=device)


def _conv_flops(b: int, t: int) -> float:
    return 2.0 * b * t * 9 * PLANES * PLANES * F_


def probe_conv_kernel(device: torch.device, b: int = B, t: int = T, reps: int = 20) -> dict:
    """B: K5 alone on channels-last int8 planes (b, t, 28, 28, 128), int8
    out."""
    gen = torch.Generator().manual_seed(1)
    x = _randint(gen, -127, 127, (b, t, H, W, PLANES), device)
    w, s = conv_operands(gen, device)
    ms = mean_ms(lambda: int8_conv(x, w, s, *K3X3, torch.int8), reps, device)
    taps = taps_inside(H, H, 3, 1, 1) ** 2  # the taps that read the input, not its padding
    bound_ms, bound_by = bound(2 * x.numel() + w.numel() + 4 * PLANES,
                               2.0 * b * t * taps * PLANES * PLANES, "int8")
    return {"probe": "B_pallas_int8_conv3x3_kernel_only", "ms": round(ms, 4),
            "tf_per_s": _rate(_conv_flops(b, t), ms), "kernel": _route(device, "K5 int8_conv"),
            "bound_ms": round(bound_ms, 4), "bound_by": bound_by}


def conv_integrated(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                    act_scale: float) -> torch.Tensor:
    """C's function: a bf16 channels-last activation quantized by
    ``act_scale``, K5, dequantized to bf16 by its epilogue."""
    return int8_conv(quantize_activation(x, act_scale), w, s, *K3X3, torch.bfloat16)


def probe_conv_integrated(device: torch.device, b: int = B, t: int = T, reps: int = 20) -> dict:
    """C: B with the int8 model's integration around it."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((b, t, H, W, PLANES), generator=gen).to(device, torch.bfloat16)
    w, s = conv_operands(gen, device)
    ms = mean_ms(lambda: conv_integrated(x, w, s, 0.05), reps, device)
    return {"probe": "C_pallas_int8_conv3x3_with_layout", "ms": round(ms, 4),
            "tf_per_s": _rate(_conv_flops(b, t), ms),
            "kernel": _route(device, "quantize + K5 int8_conv + bf16 epilogue"),
            "layout": "channels last in and out (no relayout)"}


def probe_xla_baselines(device: torch.device, b: int = B, t: int = T, reps: int = 20) -> List[dict]:
    """D: the library's k(1,3,3) conv at the same shape: bf16 cuDNN
    ``F.conv3d`` on the NCDHW view of a channels-last activation; no int8
    one exists."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((b, t, H, W, PLANES), generator=gen).to(device, torch.bfloat16)
    x = x.permute(0, 4, 1, 2, 3)  # NCDHW view, channels-last strides (the model's layout)
    w = torch.randn((PLANES, PLANES, 1, 3, 3), generator=gen).to(device, torch.bfloat16)
    ms = mean_ms(lambda: F.conv3d(x, w, None, 1, (0, 1, 1)), reps, device)
    return [{"probe": "D_xla_conv_k133_int8", "ms": None, "tf_per_s": None,
             "library": "none: no library call (torch has no int8 conv on CUDA); K5 is probe B"},
            {"probe": "D_xla_conv_k133_bf16", "ms": round(ms, 4),
             "tf_per_s": _rate(_conv_flops(b, t), ms), "library": "F.conv3d (cuDNN on the card)"}]


def verify_kernel_correctness(device: torch.device, n_rows: int = 4) -> bool:
    """K5 on ``n_rows`` (28, 28, 128) planes bit-equal to its plain version
    and to a float64 ``F.conv2d`` of the JAX probe's row order, requantized
    to int8 (a power-of-two scale: exact halves round half to even); K4 on
    (n_rows * 784, 128) x (256, 128) bit-equal to its plain version and to
    the float64 product. Raises on a difference."""
    gen = torch.Generator().manual_seed(4)
    x = _randint(gen, -8, 8, (n_rows, 1, H, W, PLANES), device)
    w = _randint(gen, -3, 3, (PLANES, 9 * PLANES), device)
    s = torch.full((PLANES,), 2.0 ** -7, dtype=torch.float32, device=device)
    got = int8_conv(x, w, s, *K3X3, torch.int8)
    check_equal("K5 against its plain version", got, int8_conv_plain(x, w, s, *K3X3, torch.int8))
    wk = w.double().reshape(PLANES, 3, 3, PLANES).permute(0, 3, 1, 2)  # (O, I, kh, kw)
    acc = F.conv2d(x[:, 0].permute(0, 3, 1, 2).double(), wk, padding=1)
    ref = torch.clamp(torch.round(acc * 2.0 ** -7), -127, 127).to(torch.int8)
    check_equal("K5 against F.conv2d", got, ref.permute(0, 2, 3, 1)[:, None].contiguous())
    a = _randint(gen, -127, 127, (n_rows * F_, PLANES), device)
    w4 = _randint(gen, -127, 127, (256, PLANES), device)
    got = int8_matmul(a, w4)
    check_equal("K4 against its plain version", got, int8_matmul_plain(a, w4))
    exact = (a.double() @ w4.double().t()).to(torch.int32)
    check_equal("K4 against the float64 product", got, exact)
    return True


def run(device: torch.device, b: int = B, t: int = T, reps: int = 20) -> Iterator[dict]:
    """The JAX probe's records, A to D, each section guarded."""
    for probe in (probe_raw_matmul, probe_conv_kernel, probe_conv_integrated):
        yield from guarded(probe.__name__, lambda: probe(device, b, t, reps))
    yield from guarded("probe_xla_baselines", lambda: probe_xla_baselines(device, b, t, reps))


# ------------------------------------------------ chip_smoke.py phase 4

def int8_operands(gen: torch.Generator, m: int, k: int, n: int):
    """Seeded int8 activations (m, k), K4's packed weights (n, k) and a
    per-column float32 scale on the card."""
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
    scale = torch.rand(n, generator=gen) * 1e-5 + 1e-6
    return a.cuda(), w.cuda(), scale.cuda()


def int_mm_ms(a: torch.Tensor, w: torch.Tensor, iters: int, timer=cuda_ms) -> Optional[float]:
    """Time of ``torch._int_mm`` on the same operands as K4, the library
    yardstick (the port never calls it): the packed (N, K) weights go in
    as the column-major (K, N) operand cuBLASLt prefers. None where it
    refuses the shape."""
    rhs = w.t()
    try:
        torch._int_mm(a, rhs)
    except RuntimeError:
        return None
    return timer(lambda: torch._int_mm(a, rhs), iters)


def check_int8_probe_shapes() -> None:
    """K4 and K5 at the TPU probe's own shapes on the card, bit-equal,
    with times."""
    gen = torch.Generator().manual_seed(4)
    # K4 at two edge shapes: a ragged last row tile, and the narrowest tile
    for m, k, n in ((12_345, 512, 256), (65_536, 64, 128)):
        a, w, scale = int8_operands(gen, m, k, n)
        check_equal(f"K4 ({m}, {k}) x ({n}, {k}) int32", int8_matmul(a, w), int8_matmul_plain(a, w))
        for out_dtype in (torch.float32, torch.bfloat16):
            check_equal(f"K4 ({m}, {k}) x ({n}, {k}) {out_dtype}",
                        int8_matmul(a, w, scale, out_dtype),
                        int8_matmul_plain(a, w, scale, out_dtype))
        print(f"K4 int8_matmul edge shape ({m}, {k}) x ({n}, {k}): bit-equal (int32, float32 and "
              f"bf16 epilogues)", flush=True)
    # K4: probe_raw_matmul's (B*T*784, 512) x (512, 256) -> int32, B*T = 480
    a, w, scale = int8_operands(gen, 480 * 784, 512, 256)
    check_equal("K4 probe int32", int8_matmul(a, w), int8_matmul_plain(a, w))
    check_equal("K4 probe bf16", int8_matmul(a, w, scale, torch.bfloat16),
                int8_matmul_plain(a, w, scale, torch.bfloat16))
    ms = cuda_ms(lambda: int8_matmul(a, w), 10)
    plain_ms = cuda_ms(lambda: int8_matmul_plain(a, w), 3)
    library_ms = int_mm_ms(a, w, 10)
    m, k = a.shape
    n = w.shape[0]
    bound_ms, bound_by = bound(m * k + k * n + 4 * m * n, 2.0 * m * k * n, "int8")
    library = "refused" if library_ms is None else f"{library_ms:.3f} ms"
    print(f"K4 int8_matmul probe shape ({m}, {k}) x ({n}, {k}) -> int32: bit-equal (int32 and "
          f"bf16 epilogue); {ms:.3f} ms kernel, {plain_ms:.3f} ms plain (float64), torch._int_mm "
          f"{library}, bound {bound_ms:.3f} ms ({bound_by})", flush=True)
    # host time per launch at a stage-4 shape, whose device work takes microseconds
    a, w, scale = int8_operands(gen, 3920, 1024, 512)
    rhs = w.t()
    k4_us = host_us(lambda: int8_matmul(a, w, scale, torch.bfloat16))
    lib_us = host_us(lambda: torch._int_mm(a, rhs))
    print(f"host time per launch at (3920, 1024) x (512, 1024): K4 {k4_us:.1f} us, torch._int_mm "
          f"{lib_us:.1f} us", flush=True)
    del a, w
    # K5: make_conv3x3's (B*T, 128, 28*28) planes, channels last, pad 1
    x = torch.randint(-127, 128, (240, 2, 28, 28, 128), generator=gen, dtype=torch.int8).cuda()
    w = torch.randint(-5, 6, (128, 9 * 128), generator=gen, dtype=torch.int8).cuda()  # (Cout, K)
    scale = (torch.rand(128, generator=gen) * 2e-3 + 1e-4).cuda()
    for out_dtype in (torch.int8, torch.bfloat16):
        got = int8_conv(x, w, scale, *K3X3, out_dtype)
        check_equal(f"K5 probe {out_dtype}", got, int8_conv_plain(x, w, scale, *K3X3, out_dtype))
    saturated = (got.float().abs() >= 127).float().mean().item()
    ms = cuda_ms(lambda: int8_conv(x, w, scale, *K3X3, torch.int8), 10)
    plain_ms = cuda_ms(lambda: int8_conv_plain(x, w, scale, *K3X3, torch.int8), 3)
    xb = x.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
    wb = w.to(torch.bfloat16).reshape(128, 1, 3, 3, 128).permute(0, 4, 1, 2, 3)
    bf16_conv_ms = cuda_ms(lambda: F.conv3d(xb, wb, None, 1, (0, 1, 1)), 10)
    taps = taps_inside(28, 28, 3, 1, 1) ** 2
    bound_ms, bound_by = bound(2 * x.numel() + w.numel() + 4 * 128,
                               2.0 * 240 * 2 * taps * 128 * 128, "int8")
    print(f"K5 int8_conv probe shape {tuple(x.shape)} k(1,3,3): bit-equal (int8 and bf16 "
          f"epilogues; bf16 share >= 127: {saturated:.3f}); {ms:.3f} ms kernel (int8 out), "
          f"{plain_ms:.3f} ms plain (float64), no library call (torch has no int8 conv on CUDA; "
          f"bf16 F.conv3d at this shape {bf16_conv_ms:.3f} ms), bound {bound_ms:.3f} ms "
          f"({bound_by})", flush=True)


def main(argv: Optional[List[str]] = None) -> List[dict]:
    parser = probe_parser(__doc__)
    parser.add_argument("--verify", action="store_true",
                        help="only hold K4 and K5 against their plain versions")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if args.verify:
        verify_kernel_correctness(device)
        print('{"verify": "ok"}', flush=True)
        return [{"verify": "ok"}]
    return print_records(device, run(device))


if __name__ == "__main__":
    main()
