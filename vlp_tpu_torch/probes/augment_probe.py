"""The augmentation kernels on one CUDA card, timed on the device alone: #11
``shear_rows`` (``ops/shear.py``) on both axes and #12 ``add_gaussian_noise``
(``ops/noise.py``) on [B, 224, 224] fp32 at the training steps' batch 64
and the VLP pretraining bench's 128, each beside one PyTorch call that
computes the same function (neither bit-equal, and the port calls neither):

- shear: ``F.grid_sample`` (bilinear, border padding, ``align_corners``)
  at the same source points, one 2-D pass, its grid built outside the timed
  call;
- noise: ``torch.normal(x, sigma)``, the same distribution from another
  stream.

Shear cases: the warp's own shifts (``ops/warp.shear_shifts`` at parameters
drawn over the augmentation's full ranges: a per-row ramp for axis 1, a
per-column ramp of slope sin(theta), |slope| <= 0.5, for axis 0) and random
shifts (N(0, 60^2), as ``chip_smoke.py`` draws them), at
``default_max_shift``. Noise: sigma as the step draws it (each sample 0 or
U(0, 0.01) with probability one half).

Each case is timed three ways, kernel and library in turns:

  event_ms   a CUDA event pair around each call (median of 10), as
             ``chip_smoke.py`` times kernels: a kernel shorter than its
             wrapper's host time reads as that host time
  warm_ms    device time alone: 20 calls back to back behind a spin kernel,
             the input read by the previous call, as in the step (at batch
             128 input and output, 51 MB, exceed the 50 MB L2 a little: a
             share above 100% is L2's)
  cold_ms    device time alone with the L2 flushed before each call (a 96
             MB buffer written; events around the call alone)

``host_ms = event_ms - warm_ms`` is the wrapper's host time that the event
reading includes. ``copy_warm_ms`` and ``copy_cold_ms`` time ``clone()`` of
the image the same two ways: the same bytes read and written by PyTorch's
copy, the rate a plain copy reaches on this card. ``bound_ms`` is the bytes
a call must move (the image read once and written once, the shifts or the
seeds and sigmas) over 3.35 TB/s; ``share_*`` is the bound over the device
time.

Prints one JSON line per case and batch with the card's name and power
limit; ``--output`` also writes them as a JSON list. Needs a CUDA card;
exits with code 2 without one.

  python -m vlp_tpu_torch.probes.augment_probe [--batch 64 128] \\
      [--output augment.json]
"""
from __future__ import annotations

import argparse
import json
import math
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from vlp_tpu_torch.ops.noise import (add_gaussian_noise,
                                     add_gaussian_noise_plain)
from vlp_tpu_torch.ops.shear import shear_rows, shear_rows_plain
from vlp_tpu_torch.ops.warp import default_max_shift, shear_shifts
from vlp_tpu_torch.probes._timing import (HBM_BYTES_PER_S, cold_in_turns,
                                          device_in_turns, in_turns,
                                          require_cuda)

BATCHES = (64, 128)
SIZE = 224
# standard deviation of the random shifts, in pixels
RANDOM_SHIFT = 60.0


class Case(NamedTuple):
    args: tuple  # (img, shift) or (x, seeds, sigma)
    kernel: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    library: Callable[[], torch.Tensor]
    bytes: int
    # the library's output is the same function's (shear) or another draw
    # of the same distribution (noise)
    same_function: bool


def warp_params(batch: int, gen: torch.Generator):
    """theta, tx, ty and shear [batch] over the augmentation's full ranges
    (rotation +-30 deg, translation +-20 px, pretraining's x-shear +-5 deg),
    every sample warped."""
    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(batch, generator=gen,
                                           device=gen.device)
    return (uniform(-math.pi / 6, math.pi / 6), uniform(-20.0, 20.0),
            uniform(-20.0, 20.0), uniform(-math.pi / 36, math.pi / 36))


def shear_grid(shift: torch.Tensor, max_shift: int, axis: int, h: int,
               w: int) -> torch.Tensor:
    """The [B, H, W, 2] ``grid_sample`` grid (align_corners) of the source
    points of ``shear_rows``: x + clip(shift[b, y]) along the rows (axis 1)
    or y + clip(shift[b, x]) along the columns (axis 0)."""
    dev = shift.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    s = shift.float().clamp(-float(max_shift), float(max_shift))
    if axis == 1:
        xs = xs + s[:, :, None]
    else:
        ys = ys + s[:, None, :]
    ys, xs = torch.broadcast_tensors(ys, xs)
    return torch.stack([2.0 * xs / (w - 1) - 1.0,
                        2.0 * ys / (h - 1) - 1.0], dim=-1).contiguous()


def shear_library(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """One ``F.grid_sample`` call: bilinear, border-clamped."""
    return F.grid_sample(img[:, None], grid, mode="bilinear",
                         padding_mode="border", align_corners=True)[:, 0]


def noise_sigma(batch: int, gen: torch.Generator) -> torch.Tensor:
    """Each sample's sigma as the step draws it: 0 or U(0, 0.01)."""
    dev = gen.device
    gate = torch.rand(batch, generator=gen, device=dev) < 0.5
    mag = torch.rand(batch, generator=gen, device=dev) * 0.01
    return torch.where(gate, mag, torch.zeros_like(mag))


def cases(batch: int, gen: torch.Generator, size: int = SIZE
          ) -> Dict[str, Case]:
    """The five cases at [batch, size, size] on the generator's device."""
    dev = gen.device
    img = torch.randint(0, 256, (batch, size, size), generator=gen,
                        device=dev).float()
    ms = default_max_shift(size, size)
    ramps = shear_shifts(*warp_params(batch, gen), size, size)
    rand = torch.randn(batch, size, generator=gen, device=dev) * RANDOM_SHIFT
    shifts = {"shear_ax1_ramp": (ramps[0], 1), "shear_ax0_ramp": (ramps[1], 0),
              "shear_ax1_random": (rand, 1), "shear_ax0_random": (rand, 0)}
    out = {}
    px = img.numel()
    for name, (shift, axis) in shifts.items():
        grid = shear_grid(shift, ms, axis, size, size)
        out[name] = Case(
            (img, shift), lambda s=shift, a=axis: shear_rows(img, s, ms, a),
            lambda s=shift, a=axis: shear_rows_plain(img, s, ms, a),
            lambda g=grid: shear_library(img, g),
            8 * px + 4 * shift.numel(), True)
    x = torch.rand(batch, size, size, generator=gen, device=dev) * 256.0
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (batch, 2), generator=gen,
                          device=dev, dtype=torch.int32)
    sigma = noise_sigma(batch, gen)
    wide = sigma[:, None, None].expand_as(x)
    out["noise"] = Case((x, seeds, sigma),
                        lambda: add_gaussian_noise(x, seeds, sigma),
                        lambda: add_gaussian_noise_plain(x, seeds, sigma),
                        lambda: torch.normal(x, wide),
                        8 * px + 12 * batch, False)
    return out


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a - b).abs().max().item()


def measure(name: str, case: Case, batch: int, size: int = SIZE) -> Dict:
    out, ref = case.kernel(), case.plain()
    err = _max_abs(out, ref)
    lib_err: Optional[float] = (_max_abs(case.library(), ref)
                                if case.same_function else None)
    del out, ref
    copy = case.args[0].clone
    event = in_turns(kernel=case.kernel, library=case.library)
    warm = device_in_turns(kernel=case.kernel, library=case.library,
                           copy=copy)
    cold = cold_in_turns(kernel=case.kernel, library=case.library, copy=copy)
    bound = case.bytes / HBM_BYTES_PER_S * 1e3
    rec = {"probe": "augment", "case": name, "batch": batch,
           "shape": [batch, size, size], "bytes": case.bytes,
           "bound_ms": bound, "bound_by": "bytes", "max_abs_err": err,
           "library_max_abs_err": lib_err,
           "host_ms": event["kernel"] - warm["kernel"]}
    rec["copy_warm_ms"], rec["copy_cold_ms"] = warm["copy"], cold["copy"]
    for who in ("kernel", "library"):
        rec[f"{who}_event_ms"] = event[who]
        rec[f"{who}_warm_ms"] = warm[who]
        rec[f"{who}_cold_ms"] = cold[who]
        rec[f"{who}_share_warm"] = bound / warm[who] if warm[who] else None
        rec[f"{who}_share_cold"] = bound / cold[who] if cold[who] else None
    return rec


def run(batches=BATCHES, seed: int = 0, device: str = "cuda",
        size: int = SIZE) -> List[Dict]:
    """Every case at each batch on ``device`` (a CPU device runs the plain
    versions; the tests use it for the control flow)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    records = []
    for batch in batches:
        for name, case in cases(batch, gen, size).items():
            records.append(measure(name, case, batch, size))
        if device != "cpu":
            torch.cuda.empty_cache()
    return records


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, nargs="+", default=BATCHES)
    parser.add_argument("--output", default=None)
    args = parser.parse_args(argv)
    smi = require_cuda("augment_probe")
    device = torch.cuda.get_device_name(0)
    records = [{**rec, "device": device, "nvidia_smi": smi}
               for rec in run(args.batch)]
    for rec in records:
        print(json.dumps(rec), flush=True)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
