#!/usr/bin/env python3
"""Phase 18's gradients against the CPU, beside the CPU's own spread.

    python3 tools/torch_zoo_grad_check.py [KEY ...] [--out PATH]

For each key (default: every config of ``chip_smoke.ZOO_CONFIGS``, then
YOLOF-IL as "yolof"), the step that ``chip_smoke.py`` holds against the CPU
(``family_step``: the config's seeded student, B=2 on the family's
``cmp_hw``, dropout off, the family's named gradients) runs:

- on the CPU in f32 at one thread, at the CPU workers' thread count (the
  count that ``chip_smoke.py``'s CPU sides run at) and at every core: each
  named gradient's largest relative L2 between the three is the CPU's
  thread spread, which ``THREAD_SPREAD_TOL`` stands on;
- on the card in f32, against the CPU at the workers' thread count;
- in f64 on the card and on the CPU at every core: every named gradient
  within ``chip_smoke.F64_GRAD_REL_TOL``.

TF32 stays off. Prints the card's name and power limit and one line per
gradient, writes the readings as JSON to ``--out`` (default
``chiprun_out/zoo_grad_check.json``) and exits 1 if an f64 gradient is
past its tolerance. Needs one CUDA card.
"""
import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from dskd_tpu_torch.utils.config import apply_overrides, \
    load_config  # noqa: E402


def config_of(key):
    """(family, model config, comparison canvas) of a key."""
    if key == "yolof":
        return cs.FAMILIES["yolof"], load_config(cs.YOLOF_CONFIG), \
            cs.CANVAS_HW
    fam = cs.FAMILIES[key]
    cfg = apply_overrides(load_config(cs.ZOO_CONFIGS[key]),
                          list(cs.ZOO_SETS))
    return fam, cfg, tuple(fam["cmp_hw"])


def cpu_grads(fam, cfg, dtype, hw, threads):
    torch.set_num_threads(threads)
    return cs.family_step(fam, cfg, dtype, 2, hw, "cpu")[1]


def check(key, card):
    fam, cfg, hw = config_of(key)
    cores = os.cpu_count() or 1
    counts = sorted({1, max(1, cores // cs.CPU_WORKERS), cores})
    worker = max(1, cores // cs.CPU_WORKERS)
    t0 = time.perf_counter()
    f32 = {n: cpu_grads(fam, cfg, torch.float32, hw, n) for n in counts}
    card32 = cs.family_step(fam, cfg, torch.float32, 2, hw, cs.DEVICE)[1]
    cpu64 = cpu_grads(fam, cfg, torch.float64, hw, cores)
    card64 = cs.family_step(fam, cfg, torch.float64, 2, hw, cs.DEVICE)[1]
    rows = {}
    for k in card32:
        spread = max(cs.rel_l2(f32[a][k], f32[b][k])
                     for a in counts for b in counts if a < b)
        rows[k] = dict(cpu_thread_spread_f32=spread,
                       card_vs_cpu_f32=cs.rel_l2(card32[k], f32[worker][k]),
                       card_vs_cpu_f64=cs.rel_l2(card64[k], cpu64[k]))
        print(f"{key}: grad {k}: f32 CPU thread spread ({counts} threads) "
              f"{spread:.3e}, card vs CPU ({worker} threads) "
              f"{rows[k]['card_vs_cpu_f32']:.3e}; f64 card vs CPU "
              f"{rows[k]['card_vs_cpu_f64']:.3e} (tolerance "
              f"{cs.F64_GRAD_REL_TOL}) [{card}]", flush=True)
    print(f"{key}: B=2, {hw[0]}x{hw[1]}, {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.set_num_threads(cores)
    return dict(hw=list(hw), threads=counts, grads=rows)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("keys", nargs="*",
                    default=[*cs.ZOO_CONFIGS, "yolof"])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "zoo_grad_check.json"))
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}; TF32 off")
    out = {"card": card}
    for key in args.keys:
        out[key] = check(key, card)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    bad = {(key, k): r["card_vs_cpu_f64"] for key in args.keys
           for k, r in out[key]["grads"].items()
           if not r["card_vs_cpu_f64"] <= cs.F64_GRAD_REL_TOL}
    if bad:
        print(f"f64 gradients past {cs.F64_GRAD_REL_TOL}: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise RuntimeError("this check needs a CUDA card")
    sys.exit(main(sys.argv[1:]))
