#!/usr/bin/env python3
"""Greedy NMS with its first pass over the best 4 * max_out candidates
(`ops.detection.NMS_WINDOW` = 4) against one pass over all N candidates,
at chip_smoke phase 35's SSD300, YOLOv3 and RPN shapes, in turns
(window, all, all, window) on one card: host ms and device kernels a
call, device busy ms, and outputs equal between the two.

    python3 tools/ab_nms_window.py [--seed 0]

About two minutes of command time on one H100 (no kernel is built).
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def shapes(cs, seed, dev):
    """{name: a call of the NMS at that shape} from seeded inputs."""
    from paddle_tpu_torch.ops import detection as D
    from paddle_tpu_torch.ops import detection_train as DT

    g = torch.Generator().manual_seed(seed)
    priors, var = cs.ssd_priors(dev)
    loc = torch.randn(cs.SSD_BATCH, priors.shape[0], 4, generator=g) * 0.5
    conf = torch.randn(cs.SSD_BATCH, priors.shape[0], cs.SSD_CLASSES,
                       generator=g)
    ssd_b = D.box_coder(priors, var, loc.to(dev), "decode_center_size")
    ssd_s = torch.softmax(conf.to(dev), -1).permute(0, 2, 1).contiguous()
    img = torch.full((cs.YOLO_BATCH, 2), cs.YOLO_IMG, dtype=torch.int32,
                     device=dev)
    heads = [D.yolo_box(torch.randn(cs.YOLO_BATCH, 3 * (5 + cs.YOLO_CLASSES),
                                    s, s, generator=g).to(dev), img, a,
                        cs.YOLO_CLASSES, 0.01, d, True)
             for s, d, a in cs.YOLO_HEADS]
    yolo_b = torch.cat([h[0] for h in heads], 1)
    yolo_s = torch.cat([h[1] for h in heads], 1).permute(0, 2, 1).contiguous()
    anc = D.anchor_generator(cs.FR_FEAT, cs.FR_SIZES, cs.FR_RATIOS,
                             [cs.FR_STRIDE] * 2, device=dev)[0].reshape(-1, 4)
    A = anc.shape[0]
    info = torch.tensor([float(cs.FR_IMG[0]), float(cs.FR_IMG[1]), 1.0],
                        device=dev).expand(cs.FR_BATCH, 3)
    props, sc, _ = DT._proposal_candidates(
        torch.randn(cs.FR_BATCH, A, generator=g).to(dev),
        (torch.randn(cs.FR_BATCH, A, 4, generator=g) * 0.2).to(dev), info,
        anc, None, cs.FR_PRE, 0.0)
    return {
        "SSD300": lambda: D.multiclass_nms(ssd_b, ssd_s, 0.01, 400, 200,
                                           0.45)[0],
        "YOLOv3": lambda: D.multiclass_nms(yolo_b, yolo_s, 0.01, 1000, 100,
                                           0.45, False, -1)[0],
        "RPN": lambda: D.nms(props, sc, 0.7, max_out=cs.FR_POST,
                             normalized=False)[0],
    }


if __name__ == "__main__":
    import chip_smoke as cs
    from paddle_tpu_torch.ops import detection as D

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_nms_window: no CUDA device", file=sys.stderr)
        sys.exit(2)
    print(cs.card_line(), torch.__version__, flush=True)
    calls = shapes(cs, args.seed, "cuda")
    for name, call in calls.items():
        outs = {}
        for label, window in (("window", 4), ("all N", 10 ** 9),
                              ("all N", 10 ** 9), ("window", 4)):
            D.NMS_WINDOW = window
            ms = cs.host_ms(call, "cuda", runs=2)
            kernels, busy = cs.launches(call, "cuda")
            out = call()
            if label in outs and not torch.equal(outs[label], out):
                raise AssertionError(f"{name} {label}: not repeatable")
            outs[label] = out
            print(f"{name} {label}: {ms:.2f} ms a call (host wall), "
                  f"{kernels} device kernels, device busy {busy:.2f} ms",
                  flush=True)
        D.NMS_WINDOW = 4
        same = torch.equal(outs["window"], outs["all N"])
        print(f"{name}: outputs equal {same}", flush=True)
        if not same:
            raise AssertionError(f"{name}: the window changed the output")
