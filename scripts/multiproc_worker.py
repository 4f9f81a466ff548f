"""Multi-process (true multi-host) worker: one JAX process of an
N-process CPU cluster.

Each process owns one local CPU device; ``jax.distributed.initialize``
forms the cluster (the DCN path of SURVEY.md section 2.7's comm-backend
row — on a real pod the same code spans hosts), a global 1-D mesh spans
every process, and the workload exercises the cross-process collectives
the framework relies on: ``psum`` (distributed BA reduction), ``ppermute``
(ring matching / halo exchange), and ``all_gather`` (feature assembly).

Usage (launched by tests/test_multiprocess.py):
    python scripts/multiproc_worker.py <coordinator> <nprocs> <pid>

Prints one line ``RESULT <checksum>`` that must be identical across
processes (replicated outputs prove the collectives agree).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main():
    coordinator, nprocs, pid = (sys.argv[1], int(sys.argv[2]),
                                int(sys.argv[3]))
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault("XLA_FLAGS", "")
    # one local device per process: the mesh axis spans PROCESSES
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=1"

    import jax
    jax.config.update("jax_platforms", "cpu")
    # gloo-backed CPU cross-process collectives
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass

    from popsift_tpu.utils.device import init_distributed
    init_distributed(coordinator=coordinator, num_processes=nprocs,
                     process_id=pid)

    assert jax.process_count() == nprocs, jax.process_count()
    assert jax.device_count() == nprocs

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from jax import shard_map

    mesh = Mesh(np.array(jax.devices()), ("dp",))

    # Form the gloo clique FIRST with a trivial collective: the heavy
    # pipeline compiles below can skew the two single-core processes by
    # more than gloo's 30 s connect deadline, so the rendezvous must
    # happen while both processes are still in lockstep. XLA caches the
    # clique context, so every later collective reuses these sockets.
    warm = jax.jit(shard_map(lambda x: jax.lax.psum(x, "dp"), mesh=mesh,
                             in_specs=P("dp"), out_specs=P(),
                             check_vma=False))
    np.testing.assert_allclose(
        np.asarray(warm(jnp.arange(nprocs, dtype=jnp.float32))),
        np.arange(nprocs).sum())

    # --- batched extraction across processes (tiny shapes) -------------
    from popsift_tpu.config import SiftConfig
    from popsift_tpu.pipeline import build_extract_plan, extract

    h, w = 48, 64
    cfg = SiftConfig(octaves=2, extrema_capacity=64)
    plan = build_extract_plan(cfg, h, w)

    def make_frame_sized(fh, fw, seed):
        rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:fh, 0:fw].astype(np.float64)
        img = 96.0 + 40.0 * np.sin(xx / 9.0) * np.cos(yy / 11.0)
        for _ in range(8):
            cx = rng.uniform(0.1, 0.9) * fw
            cy = rng.uniform(0.1, 0.9) * fh
            s = rng.uniform(1.5, 6.0)
            img += (rng.uniform(50, 140) * rng.choice([-1.0, 1.0])
                    * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                             / (2 * s * s)))
        return np.clip(img, 0, 255).astype(np.uint8)

    def make_frame(seed):
        return make_frame_sized(h, w, seed)

    # global batch: one frame per process; build the global array from
    # per-process local shards (the multi-host ingestion path)
    local = make_frame(seed=pid)[None]
    sharding = NamedSharding(mesh, P("dp", None, None))
    batch = jax.make_array_from_process_local_data(sharding, local,
                                                   (nprocs, h, w))

    def local_fn(imgs):
        feats = extract(imgs[0], plan)
        # cross-process collectives: total keypoints (psum), neighbor's
        # descriptor checksum (ppermute ring), gathered per-process sums
        total_kp = jax.lax.psum(feats.n_keypoints, "dp")
        desc_sum = jnp.sum(feats.desc)
        perm = [(i, (i + 1) % nprocs) for i in range(nprocs)]
        nbr = jax.lax.ppermute(desc_sum, "dp", perm)
        allsums = jax.lax.all_gather(desc_sum, "dp")
        return total_kp, nbr[None], jnp.sum(allsums)

    fn = jax.jit(shard_map(local_fn, mesh=mesh,
                           in_specs=(P("dp", None, None),),
                           out_specs=(P(), P("dp"), P()),
                           check_vma=False))
    total_kp, nbr, allsum = fn(batch)

    # --- spatially-sharded extraction ACROSS processes -----------------
    # the halo-exchange ppermutes and feature all_gathers cross the
    # process boundary here — the multi-process analog of the single-process path the
    # virtual-mesh tests exercise
    from popsift_tpu.parallel.spatial import make_sharded_extract_fn

    sp_mesh = Mesh(np.array(jax.devices()), ("sp",))
    hs, ws = 56 * nprocs, 64          # band >= the keypoint halo
    cfg_sp = SiftConfig(octaves=2, extrema_capacity=64)
    se_fn, _ = make_sharded_extract_fn(cfg_sp, hs, ws, sp_mesh)
    frame = make_frame_sized(hs, ws, seed=7)
    local_rows = frame[pid * (hs // nprocs):(pid + 1) * (hs // nprocs)]
    sp_sharding = NamedSharding(sp_mesh, P("sp", None))
    frame_g = jax.make_array_from_process_local_data(sp_sharding,
                                                     local_rows,
                                                     (hs, ws))
    sp_out = se_fn(frame_g)
    sp_kp = int(sp_out.n_keypoints)
    sp_sum = round(float(np.asarray(
        jnp.sum(sp_out.desc))), 3)

    # --- distributed BA step across processes --------------------------
    from popsift_tpu.sfm.ba import BAProblem
    from popsift_tpu.sfm.distributed import (
        make_distributed_ba_fn, partition_by_point)

    rng = np.random.default_rng(0)
    n_pts, n_cams, n_obs = 4 * nprocs, 3, 8 * nprocs
    prob = BAProblem(
        cams=jnp.asarray(rng.normal(0, 0.1, (n_cams, 6)), jnp.float32),
        points=jnp.asarray(
            rng.uniform([-1, -1, 4], [1, 1, 6], (n_pts, 3)), jnp.float32),
        intr=jnp.asarray([100.0, 100.0, 32.0, 24.0], jnp.float32),
        obs_cam=jnp.asarray(rng.integers(0, n_cams, n_obs), jnp.int32),
        obs_pt=jnp.asarray(rng.integers(0, n_pts, n_obs), jnp.int32),
        obs_uv=jnp.asarray(rng.normal(32, 8, (n_obs, 2)), jnp.float32),
        obs_valid=jnp.ones(n_obs, bool),
        cam_fixed=jnp.asarray([True, False, False]))
    sharded, _ = partition_by_point(prob, nprocs)
    # re-shard the replicated host arrays onto the process mesh
    ba_mesh = Mesh(np.array(jax.devices()), ("sp",))
    ba = make_distributed_ba_fn(ba_mesh, axis_name="sp", iters=1,
                                cg_iters=3)
    out_prob, costs = ba(sharded)
    final_cost = float(np.asarray(costs)[-1])

    checksum = (int(total_kp), round(float(allsum), 3), sp_kp, sp_sum,
                round(final_cost, 4))
    print(f"RESULT {checksum}", flush=True)
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
