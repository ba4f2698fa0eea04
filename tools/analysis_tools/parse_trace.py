"""Summarize a jax.profiler device trace: top XLA ops by total time.

Usage:
    python tools/analysis_tools/parse_trace.py /tmp/jaxprof [--top 30]

Pairs with ProfilerHook (core/hook/hooks.py) — the analog of the
reference's benchmark/profile utilities: instead of wall-clock prints, it
attributes step time to actual fused XLA ops (fusions, whiles, sorts,
convolutions), which is what you optimize.
"""
import argparse
import collections
import glob
import gzip
import json
import os.path as osp
import re


def load_hlo_metadata(hlo_path):
    """op name -> "source_file:line (op_name tail)" from an optimized HLO
    text dump (tools/analysis_tools/compile_profile.py / compiled.as_text()).
    Joining the device trace against this attributes time to SOURCE LINES,
    which is far more actionable than fusion.NNN names."""
    meta = {}
    pat = re.compile(
        r"%([\w.\-]+) = .*?metadata=\{[^}]*?"
        r"(?:op_name=\"([^\"]*)\")?[^}]*?"
        r"source_file=\"([^\"]+)\"[^}]*?source_line=(\d+)")
    with open(hlo_path) as f:
        for line in f:
            m = pat.search(line)
            if m:
                name, op_name, src, ln = m.groups()
                tail = (op_name or "").split("/")[-1]
                meta[name] = f"{osp.basename(src)}:{ln} {tail}"
    return meta


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--hlo", help="optimized HLO text dump: attribute op "
                                  "time to source file:line")
    args = ap.parse_args()
    paths = sorted(glob.glob(osp.join(
        args.trace_dir, "plugins", "profile", "*", "*.trace.json.gz")))
    if not paths:
        raise SystemExit(f"no traces under {args.trace_dir}")
    path = paths[-1]
    print(f"trace: {path}")
    with gzip.open(path) as f:
        tr = json.load(f)
    durs = collections.Counter()
    for e in tr.get("traceEvents", []):
        if e.get("ph") == "X" and "dur" in e:
            name = e.get("name", "?")
            # skip host-side python frames
            if name.startswith("$") or "asarray" in name:
                continue
            durs[name] += e["dur"]
    width = max((len(n[:70]) for n, _ in durs.most_common(args.top)),
                default=10)
    print(f"{'op':{width}}  total_ms")
    for n, d in durs.most_common(args.top):
        print(f"{n[:70]:{width}}  {d / 1000:9.2f}")

    if args.hlo:
        meta = load_hlo_metadata(args.hlo)
        by_src = collections.Counter()
        unattributed = 0
        for n, d in durs.items():
            # trace names are HLO op names (sometimes suffixed); whiles and
            # the top-level jit entry are containers — skip to avoid double
            # counting their children
            if n.startswith(("jit_", "while", "PjitFunction", "conditional")):
                continue
            key = meta.get(n)
            if key is None and "." in n:
                key = meta.get(n.rsplit(".", 1)[0])
            if key is None:
                unattributed += d
            else:
                by_src[key] += d
        print(f"\n{'source line':60}  total_ms")
        for k, d in by_src.most_common(args.top):
            print(f"{k[:60]:60}  {d / 1000:9.2f}")
        print(f"{'(unattributed leaf ops)':60}  {unattributed / 1000:9.2f}")


if __name__ == "__main__":
    main()
