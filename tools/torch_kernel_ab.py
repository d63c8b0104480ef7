#!/usr/bin/env python3
"""Time the PyTorch port's kernels of two checkouts on one CUDA card, in
turns A, B, B, A.

    python3 tools/torch_kernel_ab.py PARENT_DIR [CHANGE_DIR]

Each turn is a fresh process started in the root of one checkout. It imports
that checkout's ``chip_smoke.py`` and calls its ``time_kernels`` and
``time_window_kernels``, so each side builds its own kernels (into its own
``dskd_tpu_torch/build/``) and times them at the shapes its script gives
them: the default path's kernels over the levels of the 640x640 and 640x480
canvases (``gather_weighted_bwd`` also level by level), and the windowed
family at level 0 (``window_gather_bwd`` beside ``torch.index_add``). Both
sides time with the two timers of the ``chip_smoke.py`` beside this script,
put in place of their own: device ms (``device_ms``, the calls queued behind
a spin kernel: what they take on the card) and CUDA events around the calls
(``cuda_ms``, which also count the host whenever it launches slower than
the card runs). CHANGE_DIR
defaults to the checkout that holds this script. Prints the card's name and
power limit, one JSON line per turn, and for every timing the two sides'
means and their ratio (change / parent), on one card in one run, so that
run-to-run spread between cards does not enter the ratio.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def timers():
    """{mode: timer} of the checkout that holds this script, for both
    sides: ``chip_smoke.device_ms`` and ``chip_smoke.cuda_ms`` (events)."""
    spec = importlib.util.spec_from_file_location(
        "timing_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {"device": mod.device_ms, "events": mod.cuda_ms}


def turn() -> None:
    """One side: time the kernels of the checkout in the working
    directory with each timer and print them as one JSON line."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    ms = {}
    for mode, timer in timers().items():
        chip_smoke.cuda_ms = chip_smoke.device_ms = timer
        gen = torch.Generator().manual_seed(0)
        for k, v in chip_smoke.time_kernels(gen)[0].items():
            ms[f"{k} kernel {mode}"] = v[0]
            if len(v) > 2 and v[2] is not None:
                ms[f"{k} library {mode}"] = v[2]
        for k, v in chip_smoke.time_window_kernels(gen).items():
            ms[f"{k} kernel {mode}"] = v[0]
            if v[2] is not None:
                ms[f"{k} library {mode}"] = v[2]
    print("TURN " + json.dumps({"dir": os.getcwd(), "ms": ms}), flush=True)


def main(argv) -> int:
    if argv[1:] == ["--turn"]:
        turn()
        return 0
    if len(argv) not in (2, 3):
        print(__doc__)
        return 2
    parent = os.path.abspath(argv[1])
    change = os.path.abspath(argv[2]) if len(argv) == 3 else HERE
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60)
    print(f"card: {card.stdout.strip().splitlines()[0]}")
    runs = {"parent": [], "change": []}
    for side in ("parent", "change", "change", "parent"):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--turn"],
                              cwd=parent if side == "parent" else change,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"the {side} turn failed:\n{proc.stdout}"
                               f"{proc.stderr[-4000:]}")
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("TURN "))
        print(f"{side} {line[5:]}")
        runs[side].append(json.loads(line[5:])["ms"])
    print("timing: parent ms (two turns) | change ms (two turns) | "
          "change / parent")
    for key in runs["change"][0]:
        c = [r[key] for r in runs["change"]]
        if key not in runs["parent"][0]:
            print(f"  {key}: (change only) {c[0]:.4f} {c[1]:.4f}")
            continue
        p = [r[key] for r in runs["parent"]]
        print(f"  {key}: {p[0]:.4f} {p[1]:.4f} | {c[0]:.4f} {c[1]:.4f} | "
              f"{sum(c) / sum(p):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
