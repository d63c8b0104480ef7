"""Incremental (multi-task) training CLI of the port (port of
tools/train_increment.py).

    python -m dskd_tpu_torch.tools.train_increment CONFIG [--work-dir DIR]
        [--seed N] [--resume-by-task T] [--set k=v ...] [--device cpu]

``--set`` takes dotted config overrides (``data.imgpercent=0.1``). The run
is on the CUDA card unless ``--device cpu``. ``--launcher dist`` (multi-host)
is not ported and raises.
"""
from __future__ import annotations

import argparse
import logging
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="DSKD incremental train "
                                                 "(PyTorch port)")
    parser.add_argument("config")
    parser.add_argument("--work-dir", default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--resume-by-task", type=int, default=None)
    parser.add_argument("--set", nargs="*", default=[],
                        help="dotted config overrides key=value")
    parser.add_argument("--launcher", choices=["none", "dist"],
                        default="none", help="'dist' is not ported")
    parser.add_argument("--device", default="cuda")
    return parser


def config_from_args(args):
    from ..utils.config import apply_overrides, load_config

    cfg = load_config(args.config)
    if args.work_dir:
        cfg.train.work_dir = args.work_dir
    if getattr(args, "seed", None) is not None:
        cfg.train.seed = args.seed
    if getattr(args, "resume_by_task", None) is not None:
        cfg.train.resume_by_task = args.resume_by_task
    return apply_overrides(cfg, args.set)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.launcher != "none":
        raise NotImplementedError("--launcher dist (multi-host) is not "
                                  "ported")
    from ..train.incremental import run_incremental

    cfg = config_from_args(args)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(asctime)s %(levelname)s %(message)s")
    return run_incremental(cfg, device=args.device)


if __name__ == "__main__":
    main()
