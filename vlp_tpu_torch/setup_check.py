"""Environment check: imports, the device, one kernel, a 5-step train
(counterpart of ``vlp_tpu/setup_check.py:56-75``, itself the reference's
``src/setup_test.py``).

    python -m vlp_tpu_torch.setup_check [--device cuda|cpu]

Checks the port's packages (torch, numpy, ``vlp_tpu_torch``); on ``cuda``
also the card, ``nvcc`` and one kernel built through ``ops/_build.py``
(``attend_qkv`` on a small bf16 input against its plain version). Then
five Adam steps of a tiny MLP on the device, whose loss must fall. Exits 1
on any failure; nothing falls back to the CPU.
"""
from __future__ import annotations

import argparse
import importlib
import sys
from typing import List, Optional


def check_package(name: str) -> bool:
    try:
        mod = importlib.import_module(name)
        print(f"OK   {name} {getattr(mod, '__version__', '')}")
        return True
    except Exception as e:
        print(f"FAIL {name}: {type(e).__name__}: {e}")
        return False


def _check(what: str, fn) -> bool:
    try:
        detail = fn()
        print(f"OK   {what}{': ' + detail if detail else ''}")
        return True
    except Exception as e:
        print(f"FAIL {what}: {type(e).__name__}: {e}")
        return False


def _card() -> str:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    return (f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
            f"card(s), CUDA {torch.version.cuda}")


def _nvcc() -> str:
    from vlp_tpu_torch.ops import _build

    return _build.find_nvcc()


def _kernel() -> str:
    import torch

    from vlp_tpu_torch.ops import _build
    from vlp_tpu_torch.ops.block_attention import (attend_qkv,
                                                   attend_qkv_plain)

    _build.load_library()
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(2, 16, 3 * 64, generator=g, device="cuda").bfloat16()
    got = attend_qkv(qkv, 2).float()
    want = attend_qkv_plain(qkv, 2).float()
    err = float((got - want).abs().max())
    if not err <= 2 ** -6:
        raise RuntimeError(f"attend_qkv is {err} from its plain version")
    return f"attend_qkv built and launched, {err:.2e} from plain"


def test_training(device: str, steps: int = 5) -> bool:
    import torch

    dev = torch.device(device)
    g = torch.Generator().manual_seed(0)
    w1 = (torch.randn(8, 16, generator=g) * 0.1).to(dev).requires_grad_()
    w2 = (torch.randn(16, 1, generator=g) * 0.1).to(dev).requires_grad_()
    x = torch.randn(32, 8, generator=g).to(dev)
    y = torch.randn(32, 1, generator=g).to(dev)
    opt = torch.optim.Adam([w1, w2], lr=1e-2)
    losses = []
    for i in range(steps):
        loss = ((torch.tanh(x @ w1) @ w2 - y) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        print(f"step {i}: loss {losses[-1]:.5f}")
    ok = losses[-1] < losses[0]
    print("training", "OK (loss decreased)" if ok
          else "FAILED (loss did not decrease)")
    return ok


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    ok = all([check_package("torch"), check_package("numpy"),
              check_package("vlp_tpu_torch")])
    if args.device == "cuda":
        ok = all([_check("card", _card), _check("nvcc", _nvcc),
                  _check("kernel", _kernel)]) and ok
    if ok:
        try:
            ok = test_training(args.device)
        except Exception as e:
            print(f"FAIL training: {type(e).__name__}: {e}")
            ok = False
    print("SETUP", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
