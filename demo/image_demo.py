"""Image inference demo (reference demo/image_demo.py:26-32)."""
import argparse
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from oadg_tpu.apis import inference_detector, init_detector, show_result_pyplot


def main():
    p = argparse.ArgumentParser()
    p.add_argument("img", help="image file")
    p.add_argument("config", help="config file")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--out-file", default="demo_result.png")
    p.add_argument("--score-thr", type=float, default=0.3)
    args = p.parse_args()

    model = init_detector(args.config, args.checkpoint)
    result = inference_detector(model, args.img)
    show_result_pyplot(model, args.img, result, score_thr=args.score_thr,
                       out_file=args.out_file)
    print(f"wrote {args.out_file}")


if __name__ == "__main__":
    main()
