"""Evaluation CLI of the port (port of tools/test.py): restores a task
checkpoint and runs COCO bbox evaluation over that task's validation split
(catload = the task's tril row).

    python -m dskd_tpu_torch.tools.test CONFIG [--task T] [--epoch E]
        [--work-dir DIR] [--classwise] [--out FILE] [--set k=v ...]
        [--device cpu]

Without ``--epoch`` the task's latest checkpoint is used. ``--out`` writes
the detections as COCO results json. ``--tta`` is not ported and raises.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys

log = logging.getLogger("dskd_tpu")


def main(argv=None):
    parser = argparse.ArgumentParser(description="DSKD test (PyTorch port)")
    parser.add_argument("config")
    parser.add_argument("--task", type=int, default=None,
                        help="1-based task id (default: last task)")
    parser.add_argument("--epoch", type=int, default=None)
    parser.add_argument("--work-dir", default=None)
    parser.add_argument("--classwise", action="store_true")
    parser.add_argument("--tta", action="store_true",
                        help="not ported")
    parser.add_argument("--tta-scales", nargs="*", type=int, default=None)
    parser.add_argument("--out", default=None,
                        help="save detections as COCO results json")
    parser.add_argument("--set", nargs="*", default=[])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.tta or args.tta_scales:
        raise NotImplementedError("--tta (test-time augmentation) is not "
                                  "ported")

    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(asctime)s %(levelname)s %(message)s")
    from ..apis.inference import init_detector
    from ..data.loader import DataLoader
    from ..eval.evaluator import evaluate
    from ..train.checkpoint import ckpt_dir, find_latest_checkpoint
    from ..data.pipeline import PipelineConfig
    from ..train.incremental import make_datasets, resolve_device
    from .train_increment import config_from_args

    cfg = config_from_args(args)
    device = resolve_device(args.device)
    task_nums = len(cfg.data.catsplit)
    tid = args.task or task_nums
    if args.epoch is not None:
        t, e = tid, args.epoch
    else:
        ck = find_latest_checkpoint(cfg.train.work_dir, task=tid)
        if not ck:
            raise FileNotFoundError(f"no checkpoint for task {tid} in "
                                    f"{cfg.train.work_dir}")
        t, e = ck[0], ck[1]
    model, cfg = init_detector(cfg, ckpt_dir(cfg.train.work_dir, t, e),
                               device=device)
    log.info("loaded task_%d_epoch_%d", t, e)

    _, val_ds = make_datasets(cfg, tid, task_nums)
    pipe = PipelineConfig(img_scale=cfg.data.img_scale, flip_ratio=0.0,
                          max_gt=cfg.data.max_gt, bucket=cfg.data.bucket)
    loader = DataLoader(val_ds, cfg.data.samples_per_device, pipe,
                        train=False, num_workers=cfg.data.num_workers,
                        drop_last=False, pin_memory=device.type == "cuda")
    results_out = [] if args.out else None
    try:
        stats = evaluate(model, val_ds, loader, reg_max=cfg.model.reg_max,
                         score_thr=cfg.test_score_thr,
                         max_per_img=cfg.test_max_per_img,
                         classwise=args.classwise, arch=cfg.model.arch,
                         results_out=results_out)
    finally:
        loader.close()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results_out, f)
        log.info("wrote %d detections to %s", len(results_out), args.out)
    for k, v in stats.items():
        log.info("%s: %.4f", k, v)
    copypaste = " ".join(f"{stats[k]:.3f}" for k in (
        "bbox_mAP", "bbox_mAP_50", "bbox_mAP_75", "bbox_mAP_s",
        "bbox_mAP_m", "bbox_mAP_l"))
    log.info("bbox_mAP_copypaste: %s", copypaste)
    return stats


if __name__ == "__main__":
    main()
