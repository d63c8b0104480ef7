"""Forgetting A/B on the port: DSKD distillation against plain fine-tuning
across a two-task increment (port of tools/ab_forgetting.py
``synth_batch``, ``eval_split_map``, ``run_forgetting_ab`` and ``main``).

The reference's headline claim is that its distillation keeps the old
classes while incremental fine-tuning on new classes forgets them. On
synthetic painted-box data (numpy from the same seeds as the JAX tool, so
both see the same images):

  phase 1  train from the initial weights on task-1 classes {0, 1}
  phase 2a train on task-2 classes {2, 3} with the DSKD recipe, the phase-1
           model frozen as the teacher                    -> "distill"
  phase 2b train on task-2 classes {2, 3} by plain fine-tuning (old-class
           objects painted but unannotated)               -> "finetune"
  eval     VOC mAP@0.5 on held-out mixed-class images, split into
           old-class (retention) and new-class (plasticity) mAP.

Defaults are the JAX tool's: B=2, 128x128, G=6, ResNet-18, 1+1 layers, 40
queries, 4 classes, dropout 0, f32; ``main`` runs the 400/600 calibration
with "hard + teacher-first + soft" / "corr + fg_info + decode_v1" at
score_thr 0.3 and exits 1 unless distillation beats fine-tuning on old and
on combined mAP. ``margins`` holds a run to tests/test_forgetting_ab.py's
margins.

    python -m dskd_tpu_torch.tools.ab_forgetting [steps1] [steps2]
        [--device cuda|cpu] [--seed N] [--init STATE_DICT.pt]

``--init`` starts phase 1 from a saved state dict (for instance a JAX
init carried across by ``utils/weights.py state_dict_from_jax``) instead of
``init_weights(seed)``.
"""
from __future__ import annotations

import argparse
import copy
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

NUM_CLS = 4
OLD = (0, 1)
NEW = (2, 3)
# saturated, well-separated colours: class identity is trivially learnable
PALETTE = np.array([[2.0, -2.0, -2.0], [-2.0, 2.0, -2.0],
                    [-2.0, -2.0, 2.0], [2.0, 2.0, -2.0]], np.float32)


def synth_batch(seed, B, H, W, G, paint_classes, annot_classes):
    """Painted-box detection data: every box is painted (its class drawn
    from ``paint_classes``) but only boxes of ``annot_classes`` are
    annotated (valid), as old-class objects appear unlabelled in new-task
    images. Returns numpy (images, boxes, labels, valid)."""
    r = np.random.RandomState(seed)
    images = r.randn(B, H, W, 3).astype(np.float32) * 0.2
    xy = r.rand(B, G, 2).astype(np.float32) * (W - 56) + 2
    wh = r.rand(B, G, 2).astype(np.float32) * 16 + 28
    boxes = np.concatenate([xy, xy + wh], -1)
    labels = np.asarray(paint_classes)[
        r.randint(0, len(paint_classes), (B, G))].astype(np.int32)
    for b in range(B):
        for g in range(G):
            x0, y0, x1, y1 = boxes[b, g].astype(int)
            images[b, y0:y1, x0:x1] = (
                PALETTE[labels[b, g]]
                + r.randn(max(y1 - y0, 0), max(x1 - x0, 0), 3) * 0.15)
    valid = np.isin(labels, np.asarray(annot_classes))
    return images, boxes, labels, valid


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@torch.no_grad()
def eval_split_map(model, n_images, H, W, G, iou_thr=0.5, device="cuda"):
    """(old-class mAP, new-class mAP) in percent on ``n_images`` held-out
    mixed-class images (seeds 50000...), each scored with its top 20
    detections over score 0."""
    from ..eval.mean_ap import eval_map
    from ..models.gfl_detr_head import get_bboxes

    was_training = model.training
    model.eval()
    dets, anns = [], []
    hw = torch.tensor([[H, W]], dtype=torch.int32, device=device)
    for i in range(n_images):
        images, boxes, labels, _ = synth_batch(
            50_000 + i, 1, H, W, G, range(NUM_CLS), range(NUM_CLS))
        out = model(torch.from_numpy(images).to(device), hw)
        d = get_bboxes(out.head.cls_scores[-1], out.head.bbox_preds[-1], hw,
                       score_thr=0.0, max_per_img=20)
        bb, sc, lb, va = (t[0].cpu().numpy() for t in (
            d.bboxes, d.scores, d.labels, d.valid))
        dets.append([np.concatenate([bb[va & (lb == c)],
                                     sc[va & (lb == c), None]], -1)
                     for c in range(NUM_CLS)])
        anns.append(dict(bboxes=boxes[0], labels=labels[0]))
    model.train(was_training)

    def subset(classes):
        remap = {c: j for j, c in enumerate(classes)}
        sub_d = [[d[c] for c in classes] for d in dets]
        sub_a = []
        for a in anns:
            keep = np.isin(a["labels"], np.asarray(classes))
            sub_a.append(dict(
                bboxes=a["bboxes"][keep],
                labels=np.asarray([remap[int(l)]
                                   for l in a["labels"][keep]], np.int32)))
        m, _ = eval_map(sub_d, sub_a, iou_thr=iou_thr)
        return 100.0 * float(m)

    return subset(OLD), subset(NEW)


def _train(state, step, steps, seed0, B, H, W, G, paint, annot, device,
           teacher=None, log_every=0, tag="", rows=None):
    """``steps`` steps on synth_batch(seed0 + it); appends each step's
    losses to ``rows`` (a list) when given. Returns (state, ms/step on the
    host clock around the synchronised loop)."""
    from ..data.batch import Batch

    _sync(device)
    t0 = time.perf_counter()
    for it in range(steps):
        images, boxes, labels, valid = synth_batch(
            seed0 + it, B, H, W, G, paint, annot)
        batch = Batch(*(torch.from_numpy(a) for a in (
            images, np.full((B, 2), H, np.int32), boxes, labels,
            valid))).to(device)
        state, losses = step(state, batch, teacher)
        if rows is not None:
            rows.append({k: float(v) for k, v in losses.items()})
        if log_every and (it % log_every == 0 or it == steps - 1):
            print(f"  [{tag}] step {it:>4} loss={float(losses['loss']):.4f}",
                  flush=True)
    _sync(device)
    return state, (time.perf_counter() - t0) * 1e3 / max(steps, 1)


def run_forgetting_ab(steps1=300, steps2=300, B=2, H=128, W=128, G=6,
                      n_eval=16, log_every=0, seed=0,
                      cates_distill="hard + teacher-first",
                      feats_distill="corr + fg_info + decode_v1",
                      teacher_score_thr=0.3, teacher_max_per_img=8,
                      depth=18, num_encoder_layers=1,
                      num_decoder_layers=1, num_query=40, device="cuda",
                      init_state: Optional[Dict[str, torch.Tensor]] = None,
                      rows: Optional[Dict[str, List[dict]]] = None):
    """Old/new mAP of the teacher, the distilled student and the fine-tuned
    one (``teacher_old`` ... ``finetune_new``), with each phase's ms/step
    (``task1_ms``, ``distill_ms``, ``finetune_ms``) and the run's
    ``wall_s``. ``init_state`` replaces ``init_weights(seed)``; ``rows``
    (a dict) collects each phase's per-step losses under its tag."""
    from ..distill.losses import DistillConfig
    from ..models.detector import GFLDeformableDETR, init_weights
    from ..models.gfl_detr_loss import DetLossConfig
    from ..train.incremental import resolve_device
    from ..train.optim import make_optimizer
    from ..train.schedule import step_lr_schedule
    from ..train.state import TrainState, frozen_copy
    from ..train.step import make_train_step

    device = resolve_device(device)
    t_start = time.perf_counter()
    model = GFLDeformableDETR(device, num_classes=NUM_CLS,
                              num_query=num_query, depth=depth,
                              num_encoder_layers=num_encoder_layers,
                              num_decoder_layers=num_decoder_layers,
                              dropout=0.0)
    if init_state is None:
        init_weights(model, seed=seed)
    else:
        model.load_state_dict(init_state, strict=True)
    det_cfg = DetLossConfig(num_classes=NUM_CLS)

    def fresh_state(weights, key):
        student = copy.deepcopy(weights).train().requires_grad_(True)
        opt = make_optimizer(student, step_lr_schedule(
            2e-4, iters_per_epoch=10_000))
        return TrainState.create(student, opt, seed=key)

    def log(tag):
        return None if rows is None else rows.setdefault(tag, [])

    # phase 1: task-1 classes only
    plain_step = make_train_step(det_cfg, None)
    state, task1_ms = _train(fresh_state(model, 1), plain_step, steps1, 100,
                             B, H, W, G, OLD, OLD, device,
                             log_every=log_every, tag="task1",
                             rows=log("task1"))
    teacher = frozen_copy(state.model)
    t_old, t_new = eval_split_map(teacher, n_eval, H, W, G, device=device)
    print(f"after task 1      : old-mAP={t_old:6.2f}  new-mAP={t_new:6.2f}",
          flush=True)

    # phase 2a: DSKD distillation from the frozen phase-1 model
    distill_cfg = DistillConfig.from_flags(
        cates_distill=cates_distill, feats_distill=feats_distill,
        num_prev=len(OLD))
    kd_step = make_train_step(det_cfg, distill_cfg,
                              teacher_score_thr=teacher_score_thr,
                              teacher_max_per_img=teacher_max_per_img)
    state_a, distill_ms = _train(fresh_state(teacher, 2), kd_step, steps2,
                                 2000, B, H, W, G, range(NUM_CLS), NEW,
                                 device, teacher=teacher,
                                 log_every=log_every, tag="distill",
                                 rows=log("distill"))
    a_old, a_new = eval_split_map(state_a.model, n_eval, H, W, G,
                                  device=device)
    print(f"task 2 + distill  : old-mAP={a_old:6.2f}  new-mAP={a_new:6.2f}",
          flush=True)

    # phase 2b: plain fine-tuning, the forgetting baseline
    state_b, finetune_ms = _train(fresh_state(teacher, 2), plain_step,
                                  steps2, 2000, B, H, W, G, range(NUM_CLS),
                                  NEW, device, log_every=log_every,
                                  tag="finetune", rows=log("finetune"))
    b_old, b_new = eval_split_map(state_b.model, n_eval, H, W, G,
                                  device=device)
    print(f"task 2 + finetune : old-mAP={b_old:6.2f}  new-mAP={b_new:6.2f}",
          flush=True)
    return dict(teacher_old=t_old, teacher_new=t_new,
                distill_old=a_old, distill_new=a_new,
                finetune_old=b_old, finetune_new=b_new,
                task1_ms=task1_ms, distill_ms=distill_ms,
                finetune_ms=finetune_ms,
                wall_s=time.perf_counter() - t_start)


def margins(r) -> Dict[str, bool]:
    """tests/test_forgetting_ab.py's margins on a 400/600 run, by name."""
    return {
        "teacher_old > 25": r["teacher_old"] > 25.0,
        "distill_old > finetune_old + 10":
            r["distill_old"] > r["finetune_old"] + 10.0,
        "distill_old > 0.6 teacher_old":
            r["distill_old"] > 0.6 * r["teacher_old"],
        "distill_new > 0.6 finetune_new":
            r["distill_new"] > 0.6 * r["finetune_new"],
        "finetune_old < 0.25 teacher_old":
            r["finetune_old"] < 0.25 * r["teacher_old"],
        "combined distill > combined finetune + 5":
            r["distill_old"] + r["distill_new"]
            > r["finetune_old"] + r["finetune_new"] + 5.0}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("steps1", nargs="?", type=int, default=400)
    p.add_argument("steps2", nargs="?", type=int, default=600)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init", help="a state dict (torch.save) to start "
                   "phase 1 from")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    init = None if args.init is None else torch.load(args.init,
                                                     map_location="cpu")
    # the calibrated horizon: a 400-step teacher is competent, and at 600
    # task-2 steps the distilled student beats plain fine-tuning on
    # combined old + new mAP
    r = run_forgetting_ab(args.steps1, args.steps2, log_every=25,
                          seed=args.seed, device=args.device,
                          init_state=init,
                          cates_distill="hard + teacher-first + soft")
    gap = r["distill_old"] - r["finetune_old"]
    comb_d = r["distill_old"] + r["distill_new"]
    comb_f = r["finetune_old"] + r["finetune_new"]
    print(f"\nretention gap (distill - finetune, old-class mAP): "
          f"{gap:+.2f} points")
    print(f"combined old+new mAP: distill {comb_d:.2f} vs "
          f"finetune {comb_f:.2f}")
    print(f"ms/step: task1 {r['task1_ms']:.3f}, distill "
          f"{r['distill_ms']:.3f}, finetune {r['finetune_ms']:.3f}; wall "
          f"{r['wall_s']:.1f} s on {args.device}")
    if r["distill_old"] <= r["finetune_old"]:
        print("WARNING: distillation did not improve retention")
        return 1
    if comb_d <= comb_f:
        print("WARNING: distillation lost on combined old+new mAP")
        return 1
    print("forgetting A/B OK: distillation retains old classes AND "
          "wins on combined mAP")
    return 0


if __name__ == "__main__":
    sys.exit(main())
