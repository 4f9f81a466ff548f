"""Data-parallel batched extraction and neighbor matching.

This is the capability the reference cannot offer: it processes one image
at a time through a 2-stage host pipeline (popsift.cpp:171-213). Here a
batch of images is sharded over a device mesh (``dp`` axis), every device
extracts its shard with a vmapped pipeline, and cross-image descriptor
matching moves descriptors — not images — between devices with ``ppermute``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import SiftConfig
from ..pipeline import build_extract_plan, extract
from ..ops.matching import match_descriptors


def make_batched_extract_fn(cfg: SiftConfig, height: int, width: int,
                            mesh: Mesh, axis_name: str = "dp",
                            match_pairs: bool = False,
                            desc_chunk: int = 1024,
                            octave_caps: tuple | None = None):
    """Jitted fn: uint8[B, H, W] -> (SiftFeatures batched, ring matches).

    B must be divisible by the mesh size. When ``match_pairs`` is set,
    image i's descriptors are matched against image (i+1) mod B's (a ring
    over the batch — the SfM-frontend sequential-pair workload), with the
    neighbor shard's descriptors fetched via ppermute.
    """
    plan = build_extract_plan(cfg, height, width,
                              octave_caps=octave_caps)
    n = mesh.shape[axis_name]

    def local_fn(imgs):
        # scan over the local shard: DP throughput comes from the mesh
        # axis, per-device frames run back-to-back at one frame's
        # memory footprint.
        def body(_, im):
            return 0, extract(im, plan, desc_chunk=desc_chunk)
        _, feats = jax.lax.scan(body, 0, imgs)
        if not match_pairs:
            return feats, None

        # Ring match: within the local shard, pair i -> i+1; the last
        # local image pairs with the first image of the next device.
        perm = [(i, (i - 1) % n) for i in range(n)]  # send to left neighbor
        first_desc = feats.desc[:1]
        first_valid = feats.desc_valid[:1]
        nbr_desc = jax.lax.ppermute(first_desc, axis_name, perm)
        nbr_valid = jax.lax.ppermute(first_valid, axis_name, perm)
        right_desc = jnp.concatenate([feats.desc[1:], nbr_desc], axis=0)
        right_valid = jnp.concatenate([feats.desc_valid[1:], nbr_valid],
                                      axis=0)
        res = jax.vmap(partial(match_descriptors, tile=2048))(
            feats.desc, feats.desc_valid, right_desc, right_valid)
        return feats, res

    spec = P(axis_name)
    # check_vma=False: the GPU descriptor kernel's body cannot carry the
    # pvary casts that varying-axis checking inserts (no Triton lowering)
    mapped = shard_map(
        local_fn, mesh=mesh,
        in_specs=(spec,),
        out_specs=(spec, spec if match_pairs else None),
        check_vma=False)
    return jax.jit(mapped)


def make_allpairs_match_fn(mesh: Mesh, axis_name: str = "dp",
                           ratio: float = None, tile: int = 2048):
    """Block-sharded exhaustive pairwise matching (the O(N^2) SfM
    frontend plan, SURVEY.md section 7 L4).

    Returns a jitted fn: (desc f32[N, C, 128], valid bool[N, C]) sharded
    over images -> MatchResult pytree of [N, N, C] arrays (row i =
    image i's descriptors matched against every image j's set; the
    diagonal is a self-match and should be ignored by the caller).

    Systolic ring: each device keeps its left block resident and streams
    the right descriptor blocks around the ring
    (``lax.ppermute``), matching B x B image pairs per step — N^2/n
    pairs per device over n steps, with only one extra block of
    descriptors in flight per device at any time. The per-pair kernel is
    the tiled matmul matcher (ops/matching.py::match_descriptors).
    """
    from ..ops.matching import RATIO, match_descriptors
    if ratio is None:
        ratio = RATIO
    n = mesh.shape[axis_name]

    def local_fn(desc, valid):          # [B, C, 128], [B, C]
        me = jax.lax.axis_index(axis_name)
        perm = [(i, (i + 1) % n) for i in range(n)]

        def pair_block(rd, rv):
            # all (left i, right j) pairs between the resident left
            # block and the streamed right block
            return jax.vmap(
                lambda dl, vl: jax.vmap(
                    lambda dr, vr: match_descriptors(
                        dl, vl, dr, vr, ratio=ratio, tile=tile)
                )(rd, rv)
            )(desc, valid)

        def step(carry, _):
            rd, rv = carry
            res = pair_block(rd, rv)
            rd = jax.lax.ppermute(rd, axis_name, perm)
            rv = jax.lax.ppermute(rv, axis_name, perm)
            return (rd, rv), res

        _, res = jax.lax.scan(step, (desc, valid), None, length=n)
        # step k matched the right block owned by device (me - k) mod n;
        # reorder to global owner order o via reverse + roll:
        # res[::-1] rolled by me+1 puts owner o at position o.
        res = jax.tree.map(
            lambda a: jnp.roll(a[::-1], me + 1, axis=0), res)
        # [n, B(left), B(right), C] -> [B(left), n*B(right), C]
        def flatten(a):
            a = jnp.moveaxis(a, 0, 1)           # [B, n, B, C...]
            return a.reshape((a.shape[0], n * a.shape[2]) + a.shape[3:])
        return jax.tree.map(flatten, res)

    mapped = shard_map(local_fn, mesh=mesh,
                       in_specs=(P(axis_name), P(axis_name)),
                       out_specs=P(axis_name))
    return jax.jit(mapped)
