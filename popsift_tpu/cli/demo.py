"""popsift-demo equivalent: extract SIFT features from one image.

Flag vocabulary follows the reference CLI
(/root/reference/src/application/main.cpp:48-149) where meaningful
here. Output format matches output-features.txt (main.cpp:256-258,
Feature::print features.cu:308-328).
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="popsift-demo",
        description="SIFT extraction (PopSift-compatible)")
    p.add_argument("-i", "--input", required=True, help="input image (PGM/PPM/...)")
    p.add_argument("--octaves", type=int, default=-1, help="number of octaves")
    p.add_argument("--levels", type=int, default=3, help="levels per octave")
    p.add_argument("--sigma", type=float, default=1.6, help="initial sigma")
    p.add_argument("--threshold", type=float, default=0.04, help="contrast threshold")
    p.add_argument("--edge-threshold", "--edge-limit", dest="edge_limit",
                   type=float, default=10.0)
    p.add_argument("--downsampling", type=float, default=-1.0,
                   help="first octave downscale exponent (-1 = 2x upscale)")
    p.add_argument("--initial-blur", type=float, default=0.5)
    p.add_argument("--gauss-mode", default="vlfeat")
    p.add_argument("--desc-mode", default="loop",
                   choices=["loop", "iloop", "grid", "igrid", "notile"])
    p.add_argument("--popsift-mode", action="store_true", default=True)
    p.add_argument("--vlfeat-mode", action="store_true")
    p.add_argument("--opencv-mode", action="store_true")
    p.add_argument("--root-sift", action="store_true", default=True)
    p.add_argument("--classic-norm", action="store_true")
    p.add_argument("--norm-multi", type=int, default=0)
    p.add_argument("--filter-max-extrema", type=int, default=-1)
    p.add_argument("--filter-grid", type=int, default=2)
    p.add_argument("--filter-sort", default="largest",
                   choices=["random", "largest", "smallest"])
    p.add_argument("--float-mode", action="store_true",
                   help="process as float image (ImageFloat input mode, "
                        "popsift.cpp:143-148)")
    p.add_argument("--test-direct-scaling", "--direct-scaling",
                   dest="test_direct_scaling", action="store_true",
                   help="direct scaling mode: every octave built from "
                        "the input image (ScalingMode ScaleDirect; the "
                        "reference spells this --direct-scaling, "
                        "main.cpp:100)")
    p.add_argument("--ori-smoothing", default="vlfeat",
                   choices=("vlfeat", "opencv"),
                   help="orientation histogram smoothing variant — the "
                        "reference's compile-time WITH_VLFEAT_SMOOTHING "
                        "switch (s_orientation.cu:31-34) as a runtime flag")
    p.add_argument("--norm-mode", default=None,
                   choices=["rootsift", "classic"],
                   help="string form of --root-sift/--classic-norm")
    p.add_argument("--pgmread-loading", action="store_true",
                   help="force the PGM/PNM codec (no PIL fallback)")
    p.add_argument("-o", "--output", default="output-features.txt")
    p.add_argument("--dont-write", action="store_true",
                   help="skip writing the output feature file")
    p.add_argument("--write-as-uchar", action="store_true")
    p.add_argument("--print-time-info", action="store_true")
    p.add_argument("--log", action="store_true",
                   help="dump pyramid/DoG PGMs like the reference --log")
    p.add_argument("--log-dir", default="dir-log")
    p.add_argument("--print-gauss-tables", action="store_true",
                   help="dump the Gaussian filter banks (gauss_filter.cu:24-121)")
    p.add_argument("--print-dev-info", action="store_true",
                   help="print device capabilities (device_prop.cu:35-65)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def config_from_args(args):
    from popsift_tpu.config import SiftConfig
    mode = "popsift"
    if args.vlfeat_mode:
        mode = "vlfeat"
    if args.opencv_mode:
        mode = "opencv"
    return SiftConfig(
        octaves=args.octaves,
        levels=args.levels,
        sigma=args.sigma,
        threshold=args.threshold,
        edge_limit=args.edge_limit,
        upscale_factor=-args.downsampling,
        gauss_mode=args.gauss_mode,
        sift_mode=mode,
        desc_mode=args.desc_mode,
        norm_mode=args.norm_mode if args.norm_mode else
        ("classic" if args.classic_norm else "rootsift"),
        norm_multiplier=args.norm_multi,
        initial_blur=args.initial_blur,
        assume_initial_blur=args.initial_blur > 0,
        filter_max_extrema=args.filter_max_extrema,
        filter_grid_size=args.filter_grid,
        grid_filter_mode=args.filter_sort,
        ori_smoothing=args.ori_smoothing,
        scaling_mode="direct" if args.test_direct_scaling else "indirect",
        verbose=args.verbose,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    from popsift_tpu.utils.device import enable_compile_cache
    enable_compile_cache()
    from popsift_tpu.api import PopSift
    from popsift_tpu.io.image import load_image

    if args.print_dev_info:
        from popsift_tpu.utils.device import device_report
        device_report()

    if args.pgmread_loading:
        from popsift_tpu.io.image import read_pgm
        img = read_pgm(args.input)
    else:
        img = load_image(args.input)
    if args.float_mode:
        # ImageFloat input mode (s_image.cu:264-293): element-type float
        import numpy as np
        img = img.astype(np.float32) / 255.0
    cfg = config_from_args(args)

    if args.print_gauss_tables:
        from popsift_tpu.gauss import build_gauss_tables
        t = build_gauss_tables(cfg)
        for name, sig, spn, fil in (("inc", t.inc_sigma, t.inc_span, t.inc),
                                    ("abs_o0", t.abs_o0_sigma,
                                     t.abs_o0_span, t.abs_o0),
                                    ("abs_oN", t.abs_oN_sigma,
                                     t.abs_oN_span, t.abs_oN)):
            print(f"{name}:")
            for lvl in range(cfg.total_levels):
                taps = " ".join(f"{v:.6f}" for v in
                                fil[lvl][:int(spn[lvl])])
                print(f"  level {lvl}: sigma {float(sig[lvl]):.6f} "
                      f"span {int(spn[lvl])}: {taps}")
    ps = PopSift(cfg)

    t0 = time.perf_counter()
    job = ps.enqueue(img)
    feats = job.get()
    dt = time.perf_counter() - t0

    print(f"Number of features:    {feats.getFeatureCount()}")
    print(f"Number of descriptors: {feats.getDescriptorCount()}")
    if args.print_time_info:
        print(f"Time: {dt * 1000:.1f} ms (including compilation on first call)")

    if not args.dont_write:
        feats.save(args.output, write_as_uchar=args.write_as_uchar)

    if args.log:
        import os
        from popsift_tpu.io.image import write_pgm
        from popsift_tpu.pipeline import build_extract_plan
        from popsift_tpu.ops.pyramid import build_pyramid
        import jax
        os.makedirs(args.log_dir, exist_ok=True)
        plan = build_extract_plan(cfg, *img.shape)
        blurs, dogs = jax.jit(lambda x: build_pyramid(x, plan.pyramid))(img)
        for o, (b, d) in enumerate(zip(blurs, dogs)):
            import numpy as np
            b = np.asarray(b)
            d = np.asarray(d)
            for lvl in range(b.shape[0]):
                write_pgm(f"{args.log_dir}/pyramid-o-{o}-l-{lvl}.pgm", b[lvl])
            for lvl in range(d.shape[0]):
                write_pgm(f"{args.log_dir}/d-dog-o-{o}-l-{lvl}.pgm",
                          d[lvl], scaled=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
