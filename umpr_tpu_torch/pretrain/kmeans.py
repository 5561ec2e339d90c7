"""K-means on the device, for ABAE's aspect init (the JAX package calls
sklearn's ``KMeans(n_clusters, n_init=10)``, umpr_tpu/pretrain/abae.py:
42-46; the port depends on no sklearn).

sklearn's algorithm, in torch: the data centred on its mean; greedy
k-means++ seeding (``2 + int(log k)`` candidates a step, drawn by D^2
weight, the one that lowers the potential most kept); Lloyd's iterations
until the labels repeat or the centres move less than ``tol`` times the
mean per-feature variance (squared, summed), then one more assignment to
the final centres; an empty cluster takes the point farthest from its
centre; the best of ``n_init`` runs by inertia.  The random draws come
from an explicit CPU ``torch.Generator``, so a seed gives the same
centres on any device; sklearn's own call in the JAX package is
unseeded.  Each iteration reads one flag back to the host.
"""

from __future__ import annotations

import math

import torch

MAX_ITER, TOL = 300, 1e-4  # sklearn's defaults: Lloyd's cap, the shift tolerance


def _sq_dist(x, x_sq, c):
    """(n, k) squared distances ||x||^2 - 2 x.c + ||c||^2, clipped at 0."""
    return (x_sq[:, None] - 2.0 * (x @ c.T) + (c * c).sum(-1)[None, :]).clamp_min_(0.0)


def kmeans_plusplus(x, k, generator, x_sq=None):
    """k centres of x (n, d) by greedy k-means++ (sklearn's
    ``_kmeans_plusplus`` with unit sample weights)."""
    n = x.shape[0]
    x_sq = (x * x).sum(-1) if x_sq is None else x_sq
    trials = 2 + int(math.log(k))
    first = torch.randint(n, (1,), generator=generator).to(x.device)
    centers = [x[first]]
    closest = _sq_dist(x, x_sq, centers[0])[:, 0]
    for _ in range(1, k):
        pot = closest.double().sum()
        draws = torch.rand(trials, generator=generator, dtype=torch.float64).to(x.device)
        cand = torch.searchsorted(torch.cumsum(closest.double(), 0), draws * pot)
        cand = cand.clamp_max_(n - 1)
        dist = torch.minimum(closest[:, None], _sq_dist(x, x_sq, x[cand]))  # (n, trials)
        best = dist.double().sum(0).argmin()
        closest = dist[:, best]
        centers.append(x[cand[best]][None])
    return torch.cat(centers)


def lloyd(x, centers, tol, x_sq=None):
    """Lloyd's iterations from `centers` (k, d), as sklearn's
    ``_kmeans_single_lloyd``: (centres, labels, inertia, iterations)."""
    n, k = x.shape[0], centers.shape[0]
    x_sq = (x * x).sum(-1) if x_sq is None else x_sq
    labels_old = torch.full((n,), -1, dtype=torch.int64, device=x.device)
    strict = False
    it = 0
    for it in range(1, MAX_ITER + 1):
        dist = _sq_dist(x, x_sq, centers)
        labels = dist.argmin(1)
        sums = torch.zeros_like(centers).index_add_(0, labels, x)
        counts = torch.bincount(labels, minlength=k).to(x.dtype)
        sums, counts = _relocate_empty(x, centers, labels, sums, counts)
        new = sums / counts[:, None]
        shift = ((new - centers) ** 2).sum()
        centers = new
        same, moved_little = torch.stack([(labels == labels_old).all(),
                                          shift <= tol]).tolist()
        if same:
            strict = True
            break
        if moved_little:
            break
        labels_old = labels
    if not strict:  # labels that match the final centres
        labels = _sq_dist(x, x_sq, centers).argmin(1)
    inertia = ((x - centers[labels]) ** 2).sum()
    return centers, labels, inertia, it


def _relocate_empty(x, centers, labels, sums, counts):
    """An empty cluster takes the point farthest from its assigned centre
    (the farthest for the first empty cluster, the next for the second,
    ...), which leaves its old cluster (sklearn's
    ``_relocate_empty_clusters_dense``).  No host read: with no empty
    cluster the selects keep every value."""
    k = centers.shape[0]
    empty = counts == 0
    far = ((x - centers[labels]) ** 2).sum(-1).topk(k).indices
    src = far[(torch.cumsum(empty.long(), 0) - 1).clamp_min(0)]  # (k,)
    weight = empty.to(x.dtype)
    sums = sums.index_add(0, labels[src], -x[src] * weight[:, None])
    counts = counts.index_add(0, labels[src], -weight)
    return (torch.where(empty[:, None], x[src], sums),
            torch.where(empty, torch.ones_like(counts), counts))


class KMeans:
    """``KMeans(n_clusters, n_init=10).fit(x)`` -> ``cluster_centers_``
    (k, d), ``labels_``, ``inertia_`` and ``n_iter_`` of the best run.
    ``init`` is "k-means++" or an array of starting centres (then one run,
    as sklearn takes it)."""

    def __init__(self, n_clusters, n_init=10, init="k-means++", generator=None):
        self.n_clusters = n_clusters
        self.n_init = n_init
        self.init = init
        self.generator = generator if generator is not None else torch.Generator()

    def fit(self, x):
        x = torch.as_tensor(x)
        if x.shape[0] < self.n_clusters:
            raise ValueError(f"{x.shape[0]} samples cannot make {self.n_clusters} clusters")
        mean = x.mean(0)
        xc = x - mean
        x_sq = (xc * xc).sum(-1)
        tol = (xc.var(0, unbiased=False).mean() * TOL).item()
        given = not isinstance(self.init, str)
        best = None
        for _ in range(1 if given else self.n_init):
            start = (torch.as_tensor(self.init, dtype=x.dtype, device=x.device) - mean if given
                     else kmeans_plusplus(xc, self.n_clusters, self.generator, x_sq))
            run = lloyd(xc, start, tol, x_sq)
            if best is None or run[2].item() < best[2].item():
                best = run
        centers, labels, inertia, n_iter = best
        self.cluster_centers_ = centers + mean
        self.labels_ = labels
        self.inertia_ = inertia.item()
        self.n_iter_ = n_iter
        return self
