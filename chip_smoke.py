"""Smoke test of the whole system on one NVIDIA GPU (or, with --four, of
the mesh paths on four).

Drives the entry points a user calls — ``api.PopSift`` (enqueue/get,
enqueue_batch, calibrate), ``pipeline.extract``, the ``popsift-demo`` and
``popsift-match`` CLIs, ``ops.matching`` and one SfM solve — at the
benchmark's width (1920x1080 frames, 2x upscale: octave 0 is 3840x2160),
and compares each with a plain reference: the NumPy-oracle golden
fixtures, the XLA form of the descriptor kernel, the same program on the
host CPU, and float64 NumPy matching.

    python chip_smoke.py           # one GPU: every phase
    python chip_smoke.py --four    # four GPUs: the mesh phase only

One line per phase with its wall time and comparison numbers; the last
line is a JSON object with ``"ok": true`` and the device. Any failed
check raises: the script then exits non-zero without that line. There is
no CPU fallback: without a GPU it stops at the first phase.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W = 1080, 1920
RECORD_KP, RECORD_DESC = 2110, 2505   # frame 0, CPU/XLA record


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def require_gpu(backend: str) -> None:
    check(backend == "gpu", f"JAX backend is {backend!r}, not 'gpu': this "
          "smoke test needs an NVIDIA GPU")


def require_devices(n_have: int, n_need: int) -> None:
    check(n_have >= n_need,
          f"--four needs {n_need} GPUs, JAX sees {n_have}")


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps({"ok": True, "device": {"platform": platform,
                                              "kind": kind,
                                              "count": count}})


@contextlib.contextmanager
def phase(name: str, info: dict):
    """Time one phase; print its line with the numbers it put in
    ``info``. An exception propagates (the run fails)."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    nums = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[phase] {name}: ok {dt:.1f}s {nums}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    line = out.stdout.strip()
    check(out.returncode == 0 and line,
          f"nvidia-smi failed: {out.returncode} {out.stderr.strip()}")
    return line


def shifted(img: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """``img`` moved by (dy, dx) px, the uncovered border edge-filled."""
    out = np.pad(img, ((dy, 0), (dx, 0)), mode="edge")
    return out[:img.shape[0], :img.shape[1]]


def octave_jobs(img, plan, octaves):
    """Blur stacks and descriptor job lists of the given octaves, built
    by the pipeline's own stages."""
    from popsift_tpu.ops.descriptors import make_descriptor_jobs
    from popsift_tpu.ops.extrema import detect_extrema
    from popsift_tpu.ops.orientation import assign_orientations
    from popsift_tpu.ops.pyramid import build_pyramid

    cfg = plan.config
    blurs, dogs = build_pyramid(img, plan.pyramid)
    out = []
    for o in octaves:
        oh, ow = plan.pyramid.dims[o]
        ext = detect_extrema(dogs[o], cfg, plan.ext_caps[o], ow, oh)
        oris = assign_orientations(blurs[o], ext, cfg)
        out.append((blurs[o], make_descriptor_jobs(ext, oris,
                                                   plan.job_caps[o])))
    return out


def ratio_test_f64(dl, vl, dr, vr, ratio):
    """Exact float64 Lowe ratio test: (accept, best index, best/second,
    second - best)."""
    a = np.asarray(dl, np.float64)
    b = np.asarray(dr, np.float64)
    d2 = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
          - 2.0 * a @ b.T)
    d2[:, ~np.asarray(vr)] = np.inf
    idx = np.argsort(d2, axis=1)[:, :2]
    best = np.take_along_axis(d2, idx[:, :1], 1)[:, 0]
    sec = np.take_along_axis(d2, idx[:, 1:2], 1)[:, 0]
    q = best / np.maximum(sec, 1e-30)
    return (q < ratio) & np.asarray(vl), idx[:, 0], q, sec - best


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_golden():
    from popsift_tpu.api import PopSift
    from popsift_tpu.eval.golden import (flatten_host, golden_cases,
                                         golden_errors)
    info = {}
    with phase("golden", info):
        for name, (img, cfg, _) in sorted(golden_cases().items()):
            want = np.load(os.path.join(ROOT, "tests", "golden",
                                        f"{name}.npz"))
            got = flatten_host(PopSift(cfg).enqueue(img).get())
            fails, err = golden_errors(got, want)
            check(not fails, f"golden {name}: {fails}")
            info[name] = (f"kp{len(got['x'])}/desc_err"
                          f"{err['desc']:.2e}/pos_err"
                          f"{max(err['x'], err['y']):.2e}")


def phase_desc_kernel(frame0, plan):
    import jax
    from popsift_tpu.ops.descriptors import compute_descriptors

    cfg = plan.config
    info = {}
    with phase("desc_kernel", info):
        per_oct = jax.jit(lambda im: octave_jobs(im, plan, (0, 1)))(frame0)
        kern = jax.jit(lambda b, j: compute_descriptors(b, j, cfg,
                                                        impl="kernel"))
        ref = jax.jit(lambda b, j: compute_descriptors(b, j, cfg,
                                                       impl="xla"))
        lowered = kern.lower(*per_oct[0]).as_text()
        check("sift_desc_loop" in lowered, "kernel not in the program")
        for o, (blur, jobs) in enumerate(per_oct):
            got = np.asarray(kern(blur, jobs))
            want = np.asarray(ref(blur, jobs))
            valid = np.asarray(jobs.valid)
            scale = float(np.abs(want).max())
            err = float(np.abs(got - want).max())
            check(valid.sum() > 0, f"octave {o}: no jobs")
            check(err <= 2e-5 * scale, f"octave {o}: kernel error {err} "
                  f"> 2e-5 * {scale}")
            check(not np.any(got[~valid]), f"octave {o}: invalid rows "
                  "not zero")
            info[f"oct{o}"] = (f"jobs{int(valid.sum())}/{valid.size}"
                               f" err{err:.3e} max{scale:.1f}")


def phase_extract(frames, ps, plan):
    import jax
    from popsift_tpu.api import FeaturesHost
    from popsift_tpu.eval.golden import extraction_errors
    from popsift_tpu.pipeline import extract

    info = {}
    with phase("extract_1080p", info):
        lowered = jax.jit(lambda x: extract(x, plan)).lower(
            frames[0]).as_text()
        impl = ("triton kernel sift_desc_loop" if "sift_desc_loop" in
                lowered else "xla")
        print(f"descriptor implementation on {jax.devices()[0].platform}:"
              f" {impl}", flush=True)
        check(impl != "xla", "the GPU program does not use the kernel")
        t0 = time.perf_counter()
        hosts = [j.get() for j in [ps.enqueue(f) for f in frames]]
        info["enqueue_get_s"] = f"{time.perf_counter() - t0:.2f}"

        cpu = jax.devices("cpu")[0]
        t0 = time.perf_counter()
        with jax.default_device(cpu):
            raw = jax.jit(lambda x: extract(x, plan))(
                jax.device_put(frames[0], cpu))
            ref = FeaturesHost(raw)
        info["cpu_ref_s"] = f"{time.perf_counter() - t0:.1f}"
        fails, st = extraction_errors(hosts[0], ref)
        print(f"frame0 counts: gpu kp={st['kp']} desc={st['desc']}  "
              f"cpu kp={st['kp_ref']} desc={st['desc_ref']}  "
              f"record kp={RECORD_KP} desc={RECORD_DESC}", flush=True)
        check(not fails, f"gpu vs cpu: {fails}")
        info["matched"] = f"{st['matched']:.4f}"
        info["desc_err"] = f"{st['desc_err']:.2e}"

        batch = [j.get() for j in ps.enqueue_batch(frames)]
        for f, (b, h) in enumerate(zip(batch, hosts)):
            check((b.getFeatureCount(), b.getDescriptorCount())
                  == (h.getFeatureCount(), h.getDescriptorCount()),
                  f"enqueue_batch frame {f}: counts differ")
            fails, st = extraction_errors(b, h, count_tol=0.0)
            check(not fails, f"enqueue_batch frame {f}: {fails}")
        info["batch_frames"] = len(batch)
    return hosts


def phase_cli(frame0, tmp):
    from popsift_tpu.cli import demo, match
    from popsift_tpu.io.image import write_pgm

    info = {}
    with phase("cli", info):
        a = os.path.join(tmp, "frame0.pgm")
        b = os.path.join(tmp, "frame0_shift.pgm")
        feats = os.path.join(tmp, "frame0.txt")
        dy, dx = 8, 16    # whole pixels down to octave 4
        write_pgm(a, frame0)
        write_pgm(b, shifted(frame0, dy, dx))

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            check(demo.main(["-i", a, "-o", feats]) == 0, "demo failed")
        n_desc = int(buf.getvalue().split("Number of descriptors:")[1]
                     .split()[0])
        rows = open(feats).read().splitlines()
        check(len(rows) == n_desc > 0,
              f"{len(rows)} rows for {n_desc} descriptors")
        fields = [len(r.split()) for r in rows]
        check(set(fields) == {133}, f"row widths {set(fields)}")
        np.asarray([r.split() for r in rows[:50]], np.float64)  # parses
        info["demo_rows"] = len(rows)

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            check(match.main(["-l", a, "-r", b, "--max-print", "0"]) == 0,
                  "match failed")
        out = buf.getvalue()
        n_acc = int(out.split("accepted matches:")[1].split()[0])
        shifts = []
        for line in out.splitlines():
            if line.startswith("desc ") and "->" in line:
                l, r = line.split(": ", 1)[1].split(" d2=")[0].split(" -> ")
                lx, ly = map(float, l.strip("()").split(","))
                rx, ry = map(float, r.strip("()").split(","))
                shifts.append((rx - lx, ry - ly))
        shifts = np.asarray(shifts)
        good = np.mean(np.hypot(shifts[:, 0] - dx, shifts[:, 1] - dy) < 1.0)
        check(n_acc >= 0.25 * n_desc, f"{n_acc} matches of {n_desc}")
        check(good >= 0.9, f"only {good:.3f} of matches follow the shift")
        info["match_accepted"] = n_acc
        info["on_shift"] = f"{good:.4f}"


def phase_matching(ps, frame0):
    from popsift_tpu.ops.matching import (RATIO, match_descriptors,
                                          match_descriptors_q8)

    info = {}
    with phase("matching", info):
        left = ps.enqueue(frame0).getDev().raw
        right = ps.enqueue(shifted(frame0, 8, 16)).getDev().raw
        args = (left.desc, left.desc_valid, right.desc, right.desc_valid)
        acc_r, best_r, q, gap = ratio_test_f64(*args, RATIO)
        ref = set(zip(np.nonzero(acc_r)[0], best_r[acc_r]))
        n_ref = len(ref)
        check(n_ref > 100, f"only {n_ref} reference matches")

        res = match_descriptors(*args)
        acc = np.asarray(res.accept)
        got = set(zip(np.nonzero(acc)[0], np.asarray(res.best_idx)[acc]))
        diff = sorted({row for row, _ in got ^ ref})
        # a near-tie: the ratio sits on the threshold, or the two nearest
        # right descriptors are equidistant to within f32 rounding of
        # |l|^2 + |r|^2 - 2 l.r (e.g. duplicate descriptors)
        l_sq = np.sum(np.asarray(left.desc, np.float64) ** 2, axis=1)
        ties = [abs(q[r] - RATIO) < 1e-3 or gap[r] <= 1e-5 * l_sq[r]
                for r in diff]
        check(len(diff) <= max(1, 0.001 * n_ref) and all(ties),
              f"f32 matcher differs on rows {diff} of {n_ref}: ratio "
              f"{[q[r] for r in diff]} gap {[gap[r] for r in diff]}")

        r8 = match_descriptors_q8(*args)
        acc8 = np.asarray(r8.accept)
        got8 = set(zip(np.nonzero(acc8)[0], np.asarray(r8.best_idx)[acc8]))
        recall = len(got8 & ref) / n_ref
        check(recall >= 0.99, f"int8 recall {recall:.4f}")
        info.update(ref_matches=n_ref, f32_tie_rows=len(diff),
                    q8_recall=f"{recall:.4f}")


def phase_sfm():
    import jax
    import jax.numpy as jnp
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_sfm import _make_ba_problem, make_scene
    from popsift_tpu.sfm.ba import bundle_adjust, residuals
    from popsift_tpu.sfm.evaluate import ate_rmse, camera_centers
    from popsift_tpu.sfm.twoview import ransac_essential, recover_pose

    info = {}
    with phase("sfm", info):
        prob, cams_gt, _ = _make_ba_problem(np.random.default_rng(5),
                                            noise_px=0.5)
        devs = {"gpu": jax.devices()[0], "cpu": jax.devices("cpu")[0]}
        costs = {}
        for name, dev in devs.items():
            with jax.default_device(dev):
                p = jax.device_put(prob, dev)
                out, _ = bundle_adjust(p, iters=10, dense=True)
                r = np.asarray(residuals(out), np.float64)
                costs[name] = float((r * r).sum())
                ate = ate_rmse(camera_centers(np.asarray(out.cams)),
                               camera_centers(cams_gt))
                check(ate < 5e-3, f"BA on {name}: ATE {ate}")
                info[f"ba_ate_{name}"] = f"{ate:.2e}"
        g, c = costs["gpu"], costs["cpu"]
        check(abs(g - c) <= 1e-3 * c, f"BA cost gpu {g} vs cpu {c}")
        info.update(ba_cost_gpu=f"{g:.6g}", ba_cost_cpu=f"{c:.6g}")

        rng = np.random.default_rng(1)
        _, cams, (x1, x2) = make_scene(rng, n_pts=100, n_cams=2)
        x2 = x2.copy()
        n_out = 20
        x2[:n_out] = rng.uniform(-0.5, 0.5, (n_out, 2)).astype(np.float32)
        for name, dev in devs.items():
            with jax.default_device(dev):
                a, b = jax.device_put((jnp.asarray(x1), jnp.asarray(x2)),
                                      dev)
                res = ransac_essential(jax.random.PRNGKey(0), a, b,
                                       jnp.ones(100, bool), thresh=1e-6,
                                       n_hyp=256)
                inl = np.asarray(res.inliers)
                R2, t2, _ = recover_pose(res.model, a, b, res.inliers)
            R_gt, t_gt = cams[1]
            t_gt = t_gt / np.linalg.norm(t_gt)
            t_err = min(np.linalg.norm(np.asarray(t2) - t_gt),
                        np.linalg.norm(np.asarray(t2) + t_gt))
            dR = np.asarray(R2) @ R_gt.T
            rot = float(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
            check(inl[n_out:].sum() >= 70 and inl[:n_out].sum() <= 3,
                  f"RANSAC on {name}: inliers "
                  f"{inl[n_out:].sum()}, outliers {inl[:n_out].sum()}")
            check(t_err < 0.02 and rot < 0.01,
                  f"pose on {name}: t {t_err} rot {rot}")
            info[f"pose_{name}"] = f"t{t_err:.1e}/rot{rot:.1e}"


def phase_four(frames, ps, plan):
    """The mesh paths on four GPUs against single-card runs: the
    single-card references go through ``PopSift.enqueue`` with the same
    calibrated plan as the one-card phases."""
    import jax
    import jax.numpy as jnp
    from popsift_tpu.api import FeaturesHost
    from popsift_tpu.eval.golden import extraction_errors
    from popsift_tpu.ops.matching import match_descriptors
    from popsift_tpu.parallel.batch import (make_allpairs_match_fn,
                                            make_batched_extract_fn)
    from popsift_tpu.parallel.mesh import make_mesh
    from popsift_tpu.parallel.spatial import make_sharded_extract_fn
    from popsift_tpu.pipeline import build_extract_plan, extract
    from popsift_tpu.sfm.ba import bundle_adjust
    from popsift_tpu.sfm.distributed import (make_distributed_ba_fn,
                                             partition_by_point)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_sfm import _make_ba_problem

    cfg = plan.config
    h, w = frames[0].shape
    n = len(frames)
    mesh = make_mesh(n, axis_name="dp")
    info = {}
    with phase("four_dp_extract", info):
        ref = [ps.enqueue(f).getDev().raw for f in frames]
        fn = make_batched_extract_fn(cfg, h, w, mesh,
                                     octave_caps=plan.ext_caps)
        out, _ = fn(jnp.asarray(np.stack(frames)))
        for i in range(n):
            got = FeaturesHost(jax.tree.map(lambda a: a[i], out))
            fails, _ = extraction_errors(got, FeaturesHost(ref[i]),
                                         count_tol=0.0)
            check(not fails, f"batched extract frame {i}: {fails}")
        info["dp_frames"] = n

    info = {}
    with phase("four_allpairs_match", info):
        desc = jnp.stack([r.desc for r in ref])
        valid = jnp.stack([r.desc_valid for r in ref])
        allp = make_allpairs_match_fn(mesh)(desc, valid)
        n_diff = n_acc = 0
        for i in range(n):
            for j in range(n):
                one = match_descriptors(desc[i], valid[i], desc[j],
                                        valid[j])
                a1 = np.asarray(one.accept)
                a2 = np.asarray(allp.accept[i, j])
                n_acc += int(a1.sum())
                n_diff += int(np.sum(a1 != a2)) + int(np.sum(
                    a1 & (np.asarray(one.best_idx)
                          != np.asarray(allp.best_idx[i, j]))))
        check(n_diff <= 0.001 * max(n_acc, 1),
              f"all-pairs matcher differs on {n_diff} of {n_acc}")
        info["allpairs_accepted"] = n_acc

    info = {}
    with phase("four_sharded_extract", info):
        # tests/test_spatial.py's parity on a 2160-row frame; 3 octaves
        # bound the compile time of the two programs
        big = np.concatenate([frames[0], frames[1]], axis=0)
        hb, wb = big.shape
        cfg3 = cfg.replace(octaves=3)
        sfn, eff = make_sharded_extract_fn(
            cfg3, hb, wb, make_mesh(n, axis_name="sp"))
        got = FeaturesHost(sfn(jnp.asarray(big)))
        want = FeaturesHost(jax.jit(lambda x: extract(
            x, build_extract_plan(cfg3, hb, wb, octave_caps=eff)))(big))
        fails, st = extraction_errors(got, want, count_tol=0.0)
        check(not fails, f"sharded extract: {fails}")
        info["sharded_kp"] = f"{st['kp']}/{st['kp_ref']}"

    info = {}
    with phase("four_distributed_ba", info):
        prob, _, _ = _make_ba_problem(np.random.default_rng(4), n_cams=8,
                                      n_pts=400)
        sharded, _ = partition_by_point(prob, n)
        _, c_mesh = make_distributed_ba_fn(mesh, iters=6, dense=True)(
            sharded)
        _, c_one = bundle_adjust(prob, iters=6, dense=True)
        c_mesh, c_one = float(c_mesh[-1]), float(c_one[-1])
        check(abs(c_mesh - c_one) <= 1e-3 * c_one,
              f"distributed BA cost {c_mesh} vs {c_one}")
        info["ba_cost"] = f"{c_mesh:.6g}/{c_one:.6g}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh phase")
    args = ap.parse_args(argv)
    n_dev = 4 if args.four else 1

    import jax
    info = {}
    with phase("device", info):
        require_gpu(jax.default_backend())
        devs = jax.devices()
        require_devices(len(devs), n_dev)
        print(card_line(), flush=True)
        info.update(kind=repr(devs[0].device_kind), count=len(devs))

    sys.path.insert(0, ROOT)
    from bench import make_frame
    from popsift_tpu.api import PopSift
    from popsift_tpu.config import SiftConfig
    from popsift_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    frames = [make_frame(H, W, seed=i) for i in range(4)]
    ps = PopSift(SiftConfig(extrema_capacity=8192))
    plan = ps.calibrate(frames[:1])
    print(f"calibrated octave caps: {list(plan.ext_caps)}", flush=True)
    if args.four:
        phase_four(frames, ps, plan)
    else:
        phase_golden()
        phase_desc_kernel(frames[0], plan)
        phase_extract(frames, ps, plan)
        with tempfile.TemporaryDirectory() as tmp:
            phase_cli(frames[0], tmp)
        phase_matching(ps, frames[0])
        phase_sfm()
    d = jax.devices()[0]
    print(result_line(d.platform, d.device_kind, n_dev), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
