"""COCO error analysis (analog of reference
tools/analysis_tools/coco_error_analysis.py:236-309).

Decomposes per-category precision into the classic seven error bands
(Hoiem-style, as in pycocotools' analyze()):

    C75  precision at IoU .75
    C50  precision at IoU .50
    Loc  precision at IoU .10 (localization errors forgiven)
    Sim  + supercategory confusions ignored
    Oth  + all class confusions ignored
    BG   + background false positives removed
    FN   + all remaining misses removed (== 1)

The reference drives pycocotools COCOeval with params overrides
(iouThrs=[0.75,.5,.1], remapped gts with ignore/iscrowd=1); here the
self-contained ``COCOEvalBbox`` takes ``iou_thrs``/``area_ranges``
directly and "ignored" gts are expressed as crowd entries (identical
matching semantics: they absorb detections without counting as FN/FP).

Inputs: a COCO annotation json and detections as either a COCO-format
result json (list of {image_id, category_id, bbox, score}) or a pickle of
per-image per-class xyxy arrays (tools/test.py --out).

Usage:
    python tools/analysis_tools/coco_error_analysis.py result.json out_dir \\
        --ann annotations.json [--extraplots] [--areas 1024 9216 10000000000]
"""
import argparse
import json
import os
import os.path as osp
import pickle
import sys

import numpy as np

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), "..", ".."))

ERROR_TYPES = ["C75", "C50", "Loc", "Sim", "Oth", "BG", "FN"]
# fixed-order categorical colors for the seven bands (Okabe-Ito,
# colorblind-safe); identity is also carried by stacking order + legend
BAND_COLORS = ["#0072B2", "#56B4E9", "#009E73", "#E69F00", "#D55E00",
               "#CC79A7", "#999999"]


def load_gt(ann_file):
    with open(ann_file) as f:
        coco = json.load(f)
    img_ids = [im["id"] for im in coco["images"]]
    cats = {c["id"]: c for c in coco["categories"]}
    anns_by_img = {i: [] for i in img_ids}
    for a in coco["annotations"]:
        if a["image_id"] in anns_by_img:
            anns_by_img[a["image_id"]].append(a)
    return coco, img_ids, cats, anns_by_img


def load_results(res_file, img_ids, cat_ids):
    """-> per image {cat_id: (n, 5) xywh+score}."""
    per_img = [dict() for _ in img_ids]
    idx = {im: i for i, im in enumerate(img_ids)}
    if res_file.endswith((".pkl", ".pickle")):
        with open(res_file, "rb") as f:
            results = pickle.load(f)
        for i, per_class in enumerate(results):
            for ci, dets in enumerate(per_class):
                dets = np.asarray(dets)
                if len(dets) == 0:
                    continue
                xywh = np.stack([dets[:, 0], dets[:, 1],
                                 dets[:, 2] - dets[:, 0],
                                 dets[:, 3] - dets[:, 1], dets[:, 4]], -1)
                per_img[i][cat_ids[ci]] = xywh
        return per_img
    with open(res_file) as f:
        dets = json.load(f)
    buckets = {}
    for d in dets:
        if d["image_id"] not in idx:
            continue
        buckets.setdefault((idx[d["image_id"]], d["category_id"]), []).append(
            list(d["bbox"]) + [d["score"]])
    for (i, cat), rows in buckets.items():
        per_img[i][cat] = np.asarray(rows, float)
    return per_img


def build_gts(img_ids, anns_by_img, keep_cat=None, ignore_cats=(),
              relabel_to=None):
    """Per-image {cat: (xywh boxes, iscrowd)}. ``ignore_cats`` gts are
    folded into ``relabel_to`` as crowd (= ignored) entries — the
    reference's ignore=1/iscrowd=1 remapping."""
    gts = []
    for im in img_ids:
        d = {}
        for a in anns_by_img[im]:
            cat = a["category_id"]
            crowd = float(a.get("iscrowd", 0))
            if keep_cat is not None and cat != keep_cat:
                if cat in ignore_cats and relabel_to is not None:
                    cat, crowd = relabel_to, 1.0
                else:
                    continue
            d.setdefault(cat, []).append((a["bbox"], crowd))
        gts.append({c: (np.asarray([b for b, _ in rows], float),
                        np.asarray([cr for _, cr in rows], float))
                    for c, rows in d.items()})
    return gts


def area_ranges_from(areas):
    return {"allarea": (0.0, areas[2]), "small": (0.0, areas[0]),
            "medium": (areas[0], areas[1]), "large": (areas[1], areas[2])}


def makeplot(rs, ps, out_dir, class_name, iou_type):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    area_names = ["allarea", "small", "medium", "large"]
    for ai, area in enumerate(area_names):
        area_ps = ps[..., ai, 0]
        aps = [p.mean() for p in area_ps]
        curves = [p.mean(axis=-1) if p.ndim > 1 else p for p in area_ps]
        curves.insert(0, np.zeros_like(curves[0]))
        title = f"{iou_type}-{class_name}-{area}"
        fig, ax = plt.subplots(figsize=(6, 5))
        for k in range(len(ERROR_TYPES)):
            ax.plot(rs, curves[k + 1], color="black", linewidth=0.5)
            ax.fill_between(rs, curves[k], curves[k + 1],
                            color=BAND_COLORS[k],
                            label=f"[{aps[k]:.3f}] {ERROR_TYPES[k]}")
        ax.set_xlabel("recall")
        ax.set_ylabel("precision")
        ax.set_xlim(0, 1.0)
        ax.set_ylim(0, 1.0)
        ax.set_title(title)
        ax.legend(loc="lower left", fontsize="small")
        fig.savefig(osp.join(out_dir, f"{title}.png"), dpi=120)
        plt.close(fig)


def makebarplot(rs, ps, out_dir, class_name, iou_type):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    area_names = ["allarea", "small", "medium", "large"]
    fig, ax = plt.subplots(figsize=(7, 5))
    x = np.arange(len(area_names))
    width = 0.6
    n = len(ERROR_TYPES)
    title = f"{iou_type}-{class_name}-ap bar plot"
    for i in range(n - 1):
        type_ps = ps[i, ..., 0]
        aps = [p.mean() for p in type_ps.T] if type_ps.ndim > 1 \
            else [type_ps.mean()]
        rects = ax.bar(x - width / 2 + (i + 1) * width / n, aps, width / n,
                       label=ERROR_TYPES[i], color=BAND_COLORS[i])
        for r in rects:
            h = r.get_height()
            ax.annotate(f"{h * 100:2.0f}", xy=(r.get_x() + r.get_width() / 2, h),
                        xytext=(0, 3), textcoords="offset points",
                        ha="center", va="bottom", fontsize="x-small")
    ax.set_ylabel("Mean Average Precision (mAP)")
    ax.set_title(title)
    ax.set_xticks(x)
    ax.set_xticklabels(area_names)
    ax.legend(fontsize="small")
    fig.savefig(osp.join(out_dir, f"{title}.png"), dpi=120)
    plt.close(fig)


def analyze_individual_category(k, cat_id, cats, img_ids, anns_by_img,
                                per_img_dt, areas):
    from oadg_tpu.core.evaluation.coco_eval import COCOEvalBbox
    name = cats[cat_id]["name"]
    print(f"analyzing {k + 1}-{name}")
    dt = [{cat_id: d[cat_id]} if cat_id in d else {} for d in per_img_dt]
    rng = area_ranges_from(areas)
    super_cats = [c for c, v in cats.items()
                  if v.get("supercategory") == cats[cat_id].get("supercategory")
                  and c != cat_id]
    gts_super = build_gts(img_ids, anns_by_img, keep_cat=cat_id,
                          ignore_cats=set(super_cats), relabel_to=cat_id)
    ev = COCOEvalBbox(gts_super, dt, [cat_id], max_dets=(100,),
                      iou_thrs=[0.1], area_ranges=rng)
    ev.accumulate()
    ps_super = ev.precision[0, :, 0, :, :]
    other = [c for c in cats if c != cat_id]
    gts_all = build_gts(img_ids, anns_by_img, keep_cat=cat_id,
                        ignore_cats=set(other), relabel_to=cat_id)
    ev = COCOEvalBbox(gts_all, dt, [cat_id], max_dets=(100,),
                      iou_thrs=[0.1], area_ranges=rng)
    ev.accumulate()
    ps_all = ev.precision[0, :, 0, :, :]
    return ps_super, ps_all


def analyze_results(res_file, ann_file, res_types, out_dir, extraplots=False,
                    areas=(1024, 9216, 10000000000)):
    from oadg_tpu.core.evaluation.coco_eval import COCOEvalBbox, REC_THRS
    assert len(areas) == 3, "3 integers should be specified as areas"
    os.makedirs(out_dir, exist_ok=True)
    coco, img_ids, cats, anns_by_img = load_gt(ann_file)
    cat_ids = sorted(cats)
    per_img_dt = load_results(res_file, img_ids, cat_ids)
    for res_type in res_types:
        assert res_type == "bbox", "bbox only (no mask results pipeline here)"
        res_out = osp.join(out_dir, res_type)
        os.makedirs(res_out, exist_ok=True)
        gts = build_gts(img_ids, anns_by_img)
        ev = COCOEvalBbox(gts, per_img_dt, cat_ids, max_dets=(100,),
                          iou_thrs=[0.75, 0.5, 0.1],
                          area_ranges=area_ranges_from(areas))
        ev.accumulate()
        ps = ev.precision                              # (3, R, K, A, 1)
        ps = np.vstack([ps, np.zeros((4,) + ps.shape[1:])])
        for k, cat_id in enumerate(cat_ids):
            ps_super, ps_all = analyze_individual_category(
                k, cat_id, cats, img_ids, anns_by_img, per_img_dt, areas)
            ps[3, :, k] = ps_super
            ps[4, :, k] = ps_all
            ps[ps == -1] = 0
            ps[5, :, k] = ps[4, :, k] > 0
            ps[6, :, k] = 1.0
            makeplot(REC_THRS, ps[:, :, k], res_out, cats[cat_id]["name"],
                     res_type)
            if extraplots:
                makebarplot(REC_THRS, ps[:, :, k], res_out,
                            cats[cat_id]["name"], res_type)
        makeplot(REC_THRS, ps, res_out, "allclass", res_type)
        if extraplots:
            makebarplot(REC_THRS, ps, res_out, "allclass", res_type)


def main():
    ap = argparse.ArgumentParser(description="COCO Error Analysis Tool")
    ap.add_argument("result", help="result file (COCO json or test.py pkl)")
    ap.add_argument("out_dir", help="dir to save analyze result images")
    ap.add_argument("--ann", required=True, help="annotation json path")
    ap.add_argument("--types", type=str, nargs="+", default=["bbox"])
    ap.add_argument("--extraplots", action="store_true")
    ap.add_argument("--areas", type=int, nargs="+",
                    default=[1024, 9216, 10000000000])
    args = ap.parse_args()
    analyze_results(args.result, args.ann, args.types, out_dir=args.out_dir,
                    extraplots=args.extraplots, areas=args.areas)


if __name__ == "__main__":
    main()
