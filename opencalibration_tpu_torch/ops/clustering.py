"""K-means and spectral clustering for relax group formation.

Host-side re-design of reference include/opencalibration/geometry/
KMeans.hpp:12-263 and spectral_cluster.hpp:17-252 (Ng-Jordan-Weiss
normalized-Laplacian embedding via the Spectra sparse eigensolver, with
connected-component splitting and a geometric-kmeans fallback).

This runs on host (numpy/scipy): clustering partitions at most a few
thousand cameras and is negligible next to the BA solves it feeds; the
determinism contract (fixed seeding, stable tie-breaks) matters more than
device placement here.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def kmeans(points: np.ndarray, k: int, seed: int = 42, iters: int = 50):
    """K-center (farthest-point) init + Lloyd iterations, like the
    reference KMeans (deterministic). points: [N, D]. Returns labels [N]."""
    points = np.asarray(points, np.float64)
    n = points.shape[0]
    k = max(1, min(k, n))
    rng = np.random.Generator(np.random.PCG64(seed))
    centers = np.empty((k, points.shape[1]))
    first = int(rng.integers(n))
    centers[0] = points[first]
    d2 = np.sum((points - centers[0]) ** 2, axis=1)
    for i in range(1, k):
        centers[i] = points[int(np.argmax(d2))]
        d2 = np.minimum(d2, np.sum((points - centers[i]) ** 2, axis=1))
    labels = np.zeros(n, np.int64)
    for _ in range(iters):
        dists = np.sum(
            (points[:, None, :] - centers[None, :, :]) ** 2, axis=2
        )
        new_labels = np.argmin(dists, axis=1)
        if np.array_equal(new_labels, labels):
            labels = new_labels
            break
        labels = new_labels
        for i in range(k):
            mask = labels == i
            if mask.any():
                centers[i] = points[mask].mean(axis=0)
    return labels


def connected_components(n: int, edges):
    """Union-find components over edge list [(i, j), ...]. Returns labels."""
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i, j in edges:
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[max(ri, rj)] = min(ri, rj)
    roots = np.array([find(i) for i in range(n)])
    _, labels = np.unique(roots, return_inverse=True)
    return labels


# Max k-way split asked of one eigsh call. Direct NJW with k ~ m /
# max_cluster_size eigenpairs stops scaling long before the 10k-image
# survey config: shift-invert Lanczos at k ~ 200 on a 10k-node Laplacian
# exceeds 5 minutes (measured), and the relax plan cache re-pays it on
# every mesh-topology change. Above _DIRECT_K target clusters the
# partition becomes hierarchical: one cheap 16-way spectral split, then
# recursion into each coarse piece — O(log m) small eigsh calls whose
# subgraphs shrink geometrically.
_DIRECT_K = 16


def _spectral_kway(m, ei, ej, w, k, seed):
    """Ng-Jordan-Weiss k-way labels for one subgraph ([ei, ej, w] local
    indices). Raises on eigensolver failure (caller falls back). The
    shift is -0.01, NOT 0: the normalized Laplacian of a connected graph
    is exactly singular at 0, so sigma=0 shift-invert hands ARPACK a
    singular factorization (reference Spectra usage computes smallest
    eigenpairs directly, spectral_cluster.hpp:17-252)."""
    W = sp.coo_matrix(
        (np.concatenate([w, w]), (np.concatenate([ei, ej]), np.concatenate([ej, ei]))),
        shape=(m, m),
    ).tocsr()
    d = np.asarray(W.sum(axis=1)).ravel()
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(d, 1e-12))
    Dinv = sp.diags(d_inv_sqrt)
    L = sp.identity(m) - Dinv @ W @ Dinv
    nev = min(k + 1, m - 1)
    vals, vecs = spla.eigsh(L, k=nev, sigma=-0.01, which="LM", v0=np.ones(m))
    order = np.argsort(vals)
    emb = vecs[:, order[: min(k, nev)]]
    # row-normalize (Ng-Jordan-Weiss)
    norms = np.linalg.norm(emb, axis=1, keepdims=True)
    emb = emb / np.maximum(norms, 1e-12)
    return kmeans(emb, k, seed=seed)


def _partition(m, ei, ej, w, pts, max_cluster_size, seed):
    """Labels [m] for one subgraph, each cluster ~max_cluster_size.
    Hierarchical above _DIRECT_K clusters; geometric-kmeans fallback when
    the eigensolve fails or a coarse split makes no progress."""
    k = int(np.ceil(m / max_cluster_size))
    if k <= 1:
        return np.zeros(m, np.int64)
    kk = min(k, _DIRECT_K)
    try:
        coarse = _spectral_kway(m, ei, ej, w, kk, seed)
    except Exception:
        coarse = kmeans(pts, kk, seed=seed)
    if k <= _DIRECT_K:
        return coarse
    if np.bincount(coarse).max() >= m:  # degenerate split: no progress
        return kmeans(pts, k, seed=seed)
    out = np.zeros(m, np.int64)
    next_label = 0
    sub = -np.ones(m, np.int64)
    for cl in np.unique(coarse):
        sel = np.flatnonzero(coarse == cl)
        sub[:] = -1
        sub[sel] = np.arange(len(sel))
        mask = (coarse[ei] == cl) & (coarse[ej] == cl)
        rec = _partition(
            len(sel), sub[ei[mask]], sub[ej[mask]], w[mask], pts[sel],
            max_cluster_size, seed,
        )
        out[sel] = rec + next_label
        next_label += int(rec.max()) + 1
    return out


def spectral_cluster(
    n: int,
    edges,
    edge_weights,
    points: np.ndarray,
    max_cluster_size: int,
    seed: int = 42,
):
    """Partition a camera graph into clusters of ~max_cluster_size.

    Semantics follow reference spectral_cluster.hpp: split into connected
    components first; per component, embed with the normalized Laplacian's
    smallest eigenvectors and k-means in eigenspace; fall back to geometric
    k-means on the camera positions when the eigensolve fails. Components
    needing more than _DIRECT_K clusters are split hierarchically (see
    _DIRECT_K note) so the 10k-image survey clusters in seconds.

    Returns labels [n] with contiguous cluster ids.
    """
    points = np.asarray(points, np.float64)
    if n == 0:
        return np.zeros(0, np.int64)
    comp = connected_components(n, edges)
    labels = np.zeros(n, np.int64)
    next_label = 0
    edges = np.asarray(list(edges), np.int64).reshape(-1, 2)
    edge_weights = np.asarray(list(edge_weights), np.float64)

    for c in np.unique(comp):
        idx = np.where(comp == c)[0]
        m = len(idx)
        if m <= max_cluster_size:
            labels[idx] = next_label
            next_label += 1
            continue

        sub = -np.ones(n, np.int64)
        sub[idx] = np.arange(m)
        mask = (comp[edges[:, 0]] == c) & (comp[edges[:, 1]] == c)
        ei = sub[edges[mask, 0]]
        ej = sub[edges[mask, 1]]
        w = edge_weights[mask]

        sub_labels = _partition(m, ei, ej, w, points[idx], max_cluster_size, seed)

        # enforce max size by splitting oversized clusters geometrically
        out = np.zeros(m, np.int64)
        counter = 0
        for s in np.unique(sub_labels):
            sel = np.where(sub_labels == s)[0]
            if len(sel) > 2 * max_cluster_size:
                kk = int(np.ceil(len(sel) / max_cluster_size))
                g = kmeans(points[idx[sel]], kk, seed=seed)
                for gg in np.unique(g):
                    out[sel[g == gg]] = counter
                    counter += 1
            else:
                out[sel] = counter
                counter += 1
        labels[idx] = out + next_label
        next_label += counter

    return labels
