"""Video inference demo (reference demo/video_demo.py): run the detector
on every frame of a video and write/show the annotated stream."""
import argparse
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import cv2
import numpy as np

from oadg_tpu.apis import inference_detector, init_detector
from oadg_tpu.core.visualization.image import imshow_det_bboxes


def main():
    p = argparse.ArgumentParser(description="video demo")
    p.add_argument("video", help="video file")
    p.add_argument("config", help="config file")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--out", help="output video file")
    p.add_argument("--show", action="store_true")
    p.add_argument("--wait-time", type=float, default=1)
    args = p.parse_args()
    assert args.out or args.show, "specify --out and/or --show"

    model = init_detector(args.config, args.checkpoint)
    classes = model.CLASSES

    cap = cv2.VideoCapture(args.video)
    assert cap.isOpened(), f"cannot open {args.video}"
    fps = cap.get(cv2.CAP_PROP_FPS) or 25
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    writer = None
    if args.out:
        writer = cv2.VideoWriter(args.out,
                                 cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        result = inference_detector(model, frame)[0]
        bboxes = np.vstack(result) if len(result) else np.zeros((0, 5))
        labels = np.concatenate([np.full(len(r), i, np.int32)
                                 for i, r in enumerate(result)]
                                ) if len(result) else np.zeros(0, np.int32)
        drawn = imshow_det_bboxes(frame.copy(), bboxes, labels,
                                  class_names=classes,
                                  score_thr=args.score_thr, show=False)
        if writer is not None:
            writer.write(drawn.astype(np.uint8))
        if args.show:
            cv2.imshow("video_demo", drawn)
            if cv2.waitKey(int(args.wait_time)) == 27:
                break
        n += 1
        print(f"\rframe {n}", end="", flush=True)
    print()
    cap.release()
    if writer is not None:
        writer.release()
        print(f"wrote {args.out} ({n} frames)")


if __name__ == "__main__":
    main()
