"""What the experiment scripts share: timing helpers and mod_depth."""

from __future__ import annotations

import time

import torch


def device_name(device) -> str:
    """The card's name for a CUDA device, else the device itself."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return str(dev)


def best_time(fn, reps: int) -> float:
    """Seconds of the fastest of `reps` calls of fn after one warm-up
    call; fn must end in a host fetch of its result (the sync)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def mod_depth(value: torch.Tensor, env: torch.Tensor) -> torch.Tensor:
    """(env - max(0, min(v, env))) / env, NaN-propagating (NfcTech.cpp:
    71-74); cond_mod_depth of csrc/condition_step.cuh."""
    clamped = torch.clamp(torch.minimum(value, env), min=0.0)
    return (env - clamped) / env
