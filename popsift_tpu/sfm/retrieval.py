"""Image retrieval for SfM pair selection: on-device VLAD signatures.

At SfM scale, exhaustive pairwise matching is O(N^2) full descriptor
matmuls (the reference's only matching mode, features.cu:197-219, run
per pair). Standard pipelines (COLMAP vocab-tree, 1DSfM) first shortlist
likely-overlapping pairs by a cheap global image signature. This module
is the batched version: Lloyd's k-means over a descriptor sample and
VLAD residual aggregation are both expressed as dense matmuls
(assignment = argmin of a [N, K] distance matrix; the
aggregation is a one-hot [K, N] x [N, 128] matmul), and the shortlist
is one [N_img, N_img] signature-similarity matmul + top_k — no trees,
no hashing, no host loops.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("k", "iters"))
def kmeans(desc: jnp.ndarray, valid: jnp.ndarray, k: int = 32,
           iters: int = 10, seed: int = 0):
    """Lloyd's k-means on device. desc f32[N, 128] -> centers [k, 128].

    Assignment is the argmin of the dense [N, k] squared-distance
    matrix (one MXU matmul per iteration); the center update is a
    one-hot-matmul segment mean. Empty clusters keep their previous
    center. Init: k random valid rows.
    """
    N = desc.shape[0]
    w = valid.astype(jnp.float32)[:, None]
    key = jax.random.PRNGKey(seed)
    # farthest-first traversal init (deterministic k-means++): random
    # valid start, then repeatedly seed at the point farthest from the
    # chosen set. Random-row init regularly doubles up inside one true
    # cluster and Lloyd's then parks a center on a two-cluster midpoint
    # (stationary); farthest-first guarantees one seed per separated
    # cluster.
    scores = jax.random.uniform(key, (N,)) + valid.astype(jnp.float32)
    i0 = jnp.argmax(scores)
    centers0 = jnp.zeros((k, 128), desc.dtype).at[0].set(desc[i0])
    mind2 = jnp.sum((desc - desc[i0]) ** 2, axis=1) * w[:, 0]

    def seed_step(carry, i):
        centers, mind2 = carry
        nxt = jnp.argmax(mind2)
        centers = centers.at[i].set(desc[nxt])
        d2 = jnp.sum((desc - desc[nxt]) ** 2, axis=1) * w[:, 0]
        return (centers, jnp.minimum(mind2, d2)), jnp.float32(0)

    (centers, _), _ = jax.lax.scan(
        seed_step, (centers0, mind2), jnp.arange(1, k))

    def step(centers, _):
        d2 = (jnp.sum(centers * centers, 1)[None, :]
              - 2.0 * desc @ centers.T)            # [N, k] (+|d|^2 const)
        a = jnp.argmin(d2, axis=1)
        onehot = (a[:, None] == jnp.arange(k)[None, :]) \
            .astype(jnp.float32) * w               # [N, k]
        counts = jnp.sum(onehot, axis=0)           # [k]
        sums = onehot.T @ desc                     # [k, 128]
        new = jnp.where(counts[:, None] > 0,
                        sums / jnp.maximum(counts[:, None], 1.0),
                        centers)
        # reseed empty clusters to the points farthest from their
        # assigned center (random-row init regularly doubles up inside
        # one true cluster and the doubled slot would stay stale/empty
        # forever — measured: 4 of 8 planted clusters unrecovered)
        mind2 = jnp.min(d2, axis=1) * w[:, 0]
        far_idx = jax.lax.top_k(mind2, k)[1]       # [k] farthest points
        new = jnp.where(counts[:, None] > 0, new, desc[far_idx])
        return new, jnp.float32(0)

    centers, _ = jax.lax.scan(step, centers, None, length=iters)
    return centers


@jax.jit
def vlad_signature(desc: jnp.ndarray, valid: jnp.ndarray,
                   centers: jnp.ndarray) -> jnp.ndarray:
    """VLAD: per-cluster residual sums, power + L2 normalized.

    desc f32[N, 128], centers f32[K, 128] -> f32[K * 128].
    """
    k = centers.shape[0]
    w = valid.astype(jnp.float32)[:, None]
    d2 = (jnp.sum(centers * centers, 1)[None, :]
          - 2.0 * desc @ centers.T)
    a = jnp.argmin(d2, axis=1)
    onehot = (a[:, None] == jnp.arange(k)[None, :]) \
        .astype(jnp.float32) * w                   # [N, K]
    sums = onehot.T @ desc                         # [K, 128]
    counts = jnp.sum(onehot, axis=0)               # [K]
    v = sums - counts[:, None] * centers
    v = v.reshape(-1)
    v = jnp.sign(v) * jnp.sqrt(jnp.abs(v))         # power norm
    return v / jnp.maximum(jnp.linalg.norm(v), 1e-12)


def pair_shortlist(signatures: np.ndarray, top_m: int = 10):
    """Top-``top_m`` most similar partners per image from the [N, D]
    signature matrix (one [N, N] matmul + top_k). Returns a sorted
    list of unique (i, j) pairs, i < j."""
    sigs = jnp.asarray(signatures)
    sim = sigs @ sigs.T
    n = sim.shape[0]
    sim = sim - 2.0 * jnp.eye(n)                   # exclude self
    top_m = min(top_m, n - 1)
    _, idx = jax.lax.top_k(sim, top_m)             # [N, top_m]
    idx = np.asarray(idx)
    pairs = set()
    for i in range(n):
        for j in idx[i]:
            if i != int(j):
                pairs.add((min(i, int(j)), max(i, int(j))))
    return sorted(pairs)


def build_signatures(descs: dict, k: int = 32, sample: int = 4096,
                     seed: int = 0) -> np.ndarray:
    """Signatures for a dict image_id -> f32[Ni, 128] descriptor sets.

    The codebook is trained once on a cross-image sample; every image
    is then aggregated against it (signature comparability requires a
    SHARED codebook). Variable Ni is capacity-padded per power-of-two
    bucket so jit recompiles stay bounded.
    """
    rng = np.random.default_rng(seed)
    ids = sorted(descs)
    pool = np.concatenate([descs[i] for i in ids])
    take = rng.choice(len(pool), size=min(sample, len(pool)),
                      replace=False)
    sample_desc = jnp.asarray(pool[take])
    centers = kmeans(sample_desc, jnp.ones(len(take), bool), k=k)

    sigs = []
    for i in ids:
        d = descs[i]
        cap = max(64, 1 << (len(d) - 1).bit_length())
        dp = np.zeros((cap, d.shape[1]), np.float32)
        dp[:len(d)] = d
        v = np.arange(cap) < len(d)
        sigs.append(np.asarray(vlad_signature(
            jnp.asarray(dp), jnp.asarray(v), centers)))
    return np.stack(sigs)
