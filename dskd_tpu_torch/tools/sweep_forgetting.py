"""Calibration sweep of the port's forgetting A/B (port of
tools/sweep_forgetting.py): runs ``run_forgetting_ab`` for each recipe
variant and each seed, and prints one ``SWEEP {json}`` line per run, with
the combined old + new mAP of both students and the wall time; with more
than one seed, one ``SWEEP_MEAN {json}`` line per variant follows, the
mean and sample sd of each mAP over the seeds.

    python -m dskd_tpu_torch.tools.sweep_forgetting [variant ...]
        [--device cuda|cpu] [--seed N ...] [--init STATE_DICT.pt]

No variant names run them all (B=2, 128x128, G=6, 12 eval images). On the
card, matmuls and convolutions run in full f32 (TF32 off), as in
chip_smoke.py.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .ab_forgetting import run_forgetting_ab

_REF = dict(cates_distill="hard + teacher-first",
            feats_distill="corr + fg_info + decode_v1", teacher_score_thr=0.3)
_SOFT = dict(_REF, cates_distill="hard + teacher-first + soft")
VARIANTS = {
    # the reference flagship recipe (no soft KD, thr 0.3)
    "ref": dict(_REF),
    # the soft-KD term alone
    "ref+soft": dict(_SOFT),
    # the teacher threshold alone
    "ref@thr.05": dict(_REF, teacher_score_thr=0.05),
    # longer task-2 horizons
    "ref@600": dict(_REF, steps2=600),
    "ref+soft@600": dict(_SOFT, steps2=600),
    # a stronger teacher (longer task 1)
    "ref+soft@600/400": dict(_SOFT, steps1=400, steps2=600),
    "ref@600/400": dict(_REF, steps1=400, steps2=600),
    "ref@1200/400": dict(_REF, steps1=400, steps2=1200),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("variants", nargs="*", metavar="variant",
                   help=f"any of {', '.join(VARIANTS)} (default: all)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, nargs="+", default=[0],
                   help="one run per seed (the initial weights' seed)")
    p.add_argument("--init", help="a state dict (torch.save) to start "
                   "phase 1 from")
    return p


MAP_KEYS = ("teacher_old", "teacher_new", "distill_old", "distill_new",
            "finetune_old", "finetune_new", "combined_distill",
            "combined_finetune")


def summarize(runs):
    """Mean and sample sd (ddof 1) of each mAP over ``runs``."""
    out = {"n": len(runs)}
    for k in MAP_KEYS:
        v = np.asarray([r[k] for r in runs], np.float64)
        out[k] = {"mean": float(v.mean()),
                  "sd": float(v.std(ddof=1)) if len(v) > 1 else 0.0}
    return out


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    unknown = sorted(set(args.variants) - set(VARIANTS))
    if unknown:
        parser.error(f"unknown variants {unknown}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init = None if args.init is None else torch.load(args.init,
                                                     map_location="cpu")
    for name in args.variants or list(VARIANTS):
        runs = []
        for seed in args.seed:
            kw = dict(VARIANTS[name])
            t0 = time.time()
            r = run_forgetting_ab(steps1=kw.pop("steps1", 200),
                                  steps2=kw.pop("steps2", 300),
                                  B=2, H=128, W=128, G=6, n_eval=12,
                                  seed=seed, device=args.device,
                                  init_state=init, **kw)
            r["variant"] = name
            r["seed"] = seed
            r["combined_distill"] = r["distill_old"] + r["distill_new"]
            r["combined_finetune"] = r["finetune_old"] + r["finetune_new"]
            r["wall_s"] = round(time.time() - t0, 1)
            print("SWEEP " + json.dumps(r), flush=True)
            runs.append(r)
        if len(runs) > 1:
            print("SWEEP_MEAN " + json.dumps(dict(variant=name,
                                                  **summarize(runs))),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
