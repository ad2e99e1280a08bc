"""Single-pair overlap demo (port of ``oetr_tpu/pipelines/demo.py``).

Usage:
  python -m oetr_tpu_torch.pipelines.demo --pairs pairs.txt --data /imgs \\
      --checkpoint ckpt_dir --step 0 --out viz/ [--device cpu]

Loads an OETR train state, ``{checkpoint}/step_{step}`` in JAX's orbax
layout as JAX's trainer or the port's writes it
(``training/train.py::load_checkpoint``), predicts the overlap boxes of
each pair and draws them (and the ground truth, when the pair line has
it) side by side. Drawing needs cv2; the images are read with the port's
own decoders.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description="OETR single-pair overlap demo")
    ap.add_argument("--pairs", required=True,
                    help="txt: name0 name1 [gt_box0(4) gt_box1(4)] per line")
    ap.add_argument("--data", default="")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--step", type=int, default=0)
    ap.add_argument("--out", default="overlap_viz")
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..config import OETRConfig, TrainConfig
    from ..data.images import prepare_image, read_image
    from ..models.registry import check_device
    from ..training.train import create_train_state, load_checkpoint
    from ..utils.viz import visualize_overlap_gt

    check_device(args.device)
    hw = (args.size, args.size)
    model, state = create_train_state(OETRConfig(),
                                      TrainConfig(image_size=hw),
                                      device=args.device)
    if args.checkpoint:
        state = load_checkpoint(args.checkpoint, args.step, state)
    model.eval()
    os.makedirs(args.out, exist_ok=True)

    with open(args.pairs) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    for fields in lines:
        name0, name1 = fields[0], fields[1]
        p0 = prepare_image(read_image(os.path.join(args.data, name0)),
                           hw, hw)
        p1 = prepare_image(read_image(os.path.join(args.data, name1)),
                           hw, hw)
        t = lambda a: torch.from_numpy(a)[None].to(args.device)
        with torch.no_grad():
            out = model(t(p0.oetr_image), t(p1.oetr_image))
        b0 = out["pred_bbox1"][0].cpu().numpy()
        b1 = out["pred_bbox2"][0].cpu().numpy()
        gt0 = (np.array(fields[2:6], float) if len(fields) >= 10
               else np.zeros(4))
        gt1 = (np.array(fields[6:10], float) if len(fields) >= 10
               else np.zeros(4))
        name = (os.path.basename(name0) + "_" + os.path.basename(name1)
                + ".png")
        visualize_overlap_gt(p0.oetr_image * 255, b0, gt0,
                             p1.oetr_image * 255, b1, gt1,
                             path=os.path.join(args.out, name))
        print(name, "box0", np.round(b0, 1), "box1", np.round(b1, 1))


if __name__ == "__main__":
    main()
