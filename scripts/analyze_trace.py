"""Summarize an XProf .xplane.pb device trace (op-time distribution).

Companion to capture_trace.py: loads the serialized XSpace with
jax.profiler.ProfileData and prints, per device plane, the total
device-op time grouped by op category plus the top individual ops (the
reference's analog is nvprof over the CUDA pipeline, e.g. popsift.cpp's
--print-time-info counters).

    python scripts/analyze_trace.py <trace dir> --frames 4

Parsing only: runs anywhere.
"""

import argparse
import collections
import glob
import os
import re
import sys


def find_xplane(path):
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(os.path.join(path, "**", "*.xplane.pb"),
                            recursive=True))
    if not hits:
        sys.exit(f"no .xplane.pb under {path}")
    return hits[-1]


def categorize(name):
    n = name.lower()
    if "custom-call" in n or re.search(r"(sift_desc_loop|triton)", n):
        return "kernel/custom-call"
    if n.startswith("fusion") or ".fusion" in n or "loop_fusion" in n:
        return "fusion"
    if "convolution" in n or "conv" in n:
        return "convolution"
    if any(k in n for k in ("copy", "transpose", "bitcast", "reshape")):
        return "copy/layout"
    if any(k in n for k in ("all-reduce", "all-gather", "collective",
                            "reduce-scatter", "permute")):
        return "collective"
    if any(k in n for k in ("dynamic-slice", "dynamic-update", "gather",
                            "scatter", "slice", "concatenate", "pad")):
        return "slice/gather"
    if any(k in n for k in ("reduce", "sort", "select", "iota", "compare",
                            "broadcast", "convert", "dot", "scan", "while")):
        return "other-hlo"
    return "misc"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trace", help=".xplane.pb file or profile dir")
    ap.add_argument("--frames", type=int, default=1,
                    help="frames in the traced dispatch (per-frame math)")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--tiny-us", type=float, default=20.0,
                    help="threshold for the small-op tail rollup")
    args = ap.parse_args()

    from jax.profiler import ProfileData
    pb = find_xplane(args.trace)
    with open(pb, "rb") as fh:
        pd = ProfileData.from_serialized_xspace(fh.read())

    for plane in pd.planes:
        if "/device:" not in plane.name:
            continue
        for line in plane.lines:
            if line.name not in ("XLA Ops", "XLA TraceMe"):
                continue
            by_name = collections.defaultdict(lambda: [0, 0.0])
            for ev in line.events:
                ns = ev.duration_ns
                by_name[ev.name][0] += 1
                by_name[ev.name][1] += ns / 1e6
            if not by_name:
                continue
            total = sum(ms for _, ms in by_name.values())
            print(f"\n== {plane.name} / {line.name}: "
                  f"{total:.2f} ms total, {total / args.frames:.2f} ms/frame "
                  f"({sum(c for c, _ in by_name.values())} events)")
            cats = collections.defaultdict(lambda: [0, 0.0])
            tiny = [0, 0.0]
            for name, (cnt, ms) in by_name.items():
                cat = categorize(name)
                cats[cat][0] += cnt
                cats[cat][1] += ms
                if ms / cnt * 1e3 < args.tiny_us:
                    tiny[0] += cnt
                    tiny[1] += ms
            print("-- categories (count, total ms, ms/frame):")
            for cat, (cnt, ms) in sorted(cats.items(),
                                         key=lambda kv: -kv[1][1]):
                print(f"   {cat:<20} {cnt:>6}  {ms:8.2f}  "
                      f"{ms / args.frames:6.2f}")
            print(f"   tail <{args.tiny_us:.0f}us/op: {tiny[0]} events, "
                  f"{tiny[1]:.2f} ms ({tiny[1] / args.frames:.2f} ms/frame)")
            print(f"-- top {args.top} ops:")
            for name, (cnt, ms) in sorted(by_name.items(),
                                          key=lambda kv: -kv[1][1]
                                          )[:args.top]:
                print(f"   {ms:8.2f} ms  x{cnt:<5} {name[:100]}")


if __name__ == "__main__":
    main()
