"""Webcam inference demo (reference demo/webcam_demo.py): continuous
detection on a camera stream."""
import argparse
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import cv2
import numpy as np

from oadg_tpu.apis import inference_detector, init_detector
from oadg_tpu.core.visualization.image import imshow_det_bboxes


def main():
    p = argparse.ArgumentParser(description="webcam demo")
    p.add_argument("config", help="config file")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--camera-id", type=int, default=0)
    p.add_argument("--score-thr", type=float, default=0.5)
    args = p.parse_args()

    model = init_detector(args.config, args.checkpoint)
    cap = cv2.VideoCapture(args.camera_id)
    assert cap.isOpened(), f"cannot open camera {args.camera_id}"
    print("Press ESC/q to quit")
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
                                  class_names=model.CLASSES,
                                  score_thr=args.score_thr, show=False)
        cv2.imshow("webcam_demo", drawn)
        ch = cv2.waitKey(1)
        if ch in (27, ord("q"), ord("Q")):
            break
    cap.release()


if __name__ == "__main__":
    main()
