"""1-D Ripley's K spatial-clustering test.

The port's own copy of the JAX package's statistic: radius r = 1% of genome length; for each point, neighbors within +-r are
counted (optionally weighted by an edge-correction factor 2r/overlap);
K = L / (n (n-1)) * total; clustered iff K > 2r.  Neighbors are counted
with vectorized numpy searchsorted.
"""

import numpy as np


class PointPatternAnalysis:
    """Point pattern density analysis on mapped read start coordinates."""

    def __init__(self, points: list[int], length: int):
        if len(points) < 2:
            raise ValueError("Need at least 2 points.")
        self.sorted_points = np.sort(np.asarray(points, dtype=float))
        self.n = len(points)
        self.length = float(length)

    def _neighbor_counts(self, r: float) -> np.ndarray:
        pts = self.sorted_points
        left = np.searchsorted(pts, pts - r, side="left")
        right = np.searchsorted(pts, pts + r, side="right") - 1
        return right - left  # interval size minus self

    def ripleys_k(self) -> tuple[bool, float, float]:
        """Uncorrected K-function vs the 2r expectation under CSR."""
        r = 0.01 * self.length
        total_neighbors = int(self._neighbor_counts(r).sum())
        k = (self.length / (self.n * (self.n - 1))) * total_neighbors
        return (k > 2 * r), k, 2 * r

    def ripleys_k_edge_corrected(self) -> tuple[bool, float, float]:
        """Edge-corrected K: neighbor counts weighted by 2r / window overlap."""
        r = 0.01 * self.length
        pts = self.sorted_points
        neighbors = self._neighbor_counts(r)
        a = np.maximum(0.0, pts - r)
        b = np.minimum(self.length, pts + r)
        overlap = b - a
        weight = np.where(overlap > 0, (2 * r) / np.maximum(overlap, 1e-300), 0.0)
        total_weighted = float((weight * neighbors)[neighbors > 0].sum())
        k = (self.length / (self.n * (self.n - 1))) * total_weighted
        return bool(k > 2 * r), float(k), 2 * r
