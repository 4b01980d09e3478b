"""Prediction engine: per-operator random-forest latency regressors
(paper §3.3b), implemented from scratch in numpy (no sklearn offline).

Features are log-scaled shape/flops/bytes descriptors; targets are log
latency.  One compact forest per operator kind, trained from the profiling
database, generalises to unseen shapes without hardware execution.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.backend.hardware import HardwareSpec
from repro_torch.core.backend.profiling import ProfileDB
from repro_torch.core.ir import OpNode


# --------------------------------------------------------------------------
# CART regression tree + random forest (from scratch)
# --------------------------------------------------------------------------

class _Tree:
    def __init__(self, max_depth=8, min_leaf=2, n_feature_frac=0.8, rng=None):
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.n_feature_frac = n_feature_frac
        self.rng = rng or np.random.default_rng(0)
        self.nodes: list[tuple] = []  # (feat, thresh, left, right) or ('leaf', value)

    def fit(self, X: np.ndarray, y: np.ndarray):
        self.nodes = []
        self._build(X, y, 0)
        return self

    def _build(self, X, y, depth) -> int:
        idx = len(self.nodes)
        self.nodes.append(None)
        if depth >= self.max_depth or len(y) <= self.min_leaf or np.ptp(y) < 1e-9:
            self.nodes[idx] = ("leaf", float(np.mean(y)))
            return idx
        nf = X.shape[1]
        feats = self.rng.choice(nf, max(1, int(nf * self.n_feature_frac)), replace=False)
        best = None  # (sse, feat, thresh)
        for f in feats:
            xs = X[:, f]
            order = np.argsort(xs)
            xs_s, ys_s = xs[order], y[order]
            # candidate splits between distinct values
            distinct = np.nonzero(np.diff(xs_s) > 1e-12)[0]
            if len(distinct) == 0:
                continue
            cands = distinct[np.linspace(0, len(distinct) - 1,
                                         min(16, len(distinct))).astype(int)]
            csum = np.cumsum(ys_s)
            csum2 = np.cumsum(ys_s ** 2)
            n = len(ys_s)
            for c in cands:
                nl = c + 1
                nr = n - nl
                if nl < self.min_leaf or nr < self.min_leaf:
                    continue
                sl, sl2 = csum[c], csum2[c]
                sr, sr2 = csum[-1] - sl, csum2[-1] - sl2
                sse = (sl2 - sl * sl / nl) + (sr2 - sr * sr / nr)
                if best is None or sse < best[0]:
                    best = (sse, f, (xs_s[c] + xs_s[c + 1]) / 2.0)
        if best is None:
            self.nodes[idx] = ("leaf", float(np.mean(y)))
            return idx
        _, f, t = best
        mask = X[:, f] <= t
        left = self._build(X[mask], y[mask], depth + 1)
        right = self._build(X[~mask], y[~mask], depth + 1)
        self.nodes[idx] = (f, t, left, right)
        return idx

    def predict_one(self, x: np.ndarray) -> float:
        i = 0
        while True:
            node = self.nodes[i]
            if node[0] == "leaf":
                return node[1]
            f, t, l, r = node
            i = l if x[f] <= t else r


class RandomForest:
    def __init__(self, n_trees=24, max_depth=9, seed=0):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.seed = seed
        self.trees: list[_Tree] = []

    def fit(self, X: np.ndarray, y: np.ndarray):
        rng = np.random.default_rng(self.seed)
        self.trees = []
        n = len(y)
        for t in range(self.n_trees):
            rows = rng.integers(0, n, n)  # bootstrap
            tree = _Tree(max_depth=self.max_depth,
                         rng=np.random.default_rng(self.seed * 1000 + t))
            tree.fit(X[rows], y[rows])
            self.trees.append(tree)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        out = np.zeros(len(X))
        for i, x in enumerate(X):
            out[i] = float(np.mean([t.predict_one(x) for t in self.trees]))
        return out


# --------------------------------------------------------------------------
# Feature extraction
# --------------------------------------------------------------------------

def node_features(node: OpNode) -> np.ndarray:
    dims = list(node.attrs.get("mm_dims") or node.attrs.get("attn_dims")
                or node.out_shape or (1,))
    dims = (dims + [1, 1, 1, 1, 1])[:5]
    flops = max(node.flops, 1.0)
    byts = max(node.total_bytes, 1.0)
    return np.array([
        *[math.log1p(d) for d in dims],
        math.log1p(flops),
        math.log1p(byts),
        math.log1p(flops / byts),
        1.0 if node.dtype in ("bf16", "f16") else 0.0,
    ])


def entry_features(entry: dict) -> np.ndarray:
    dims = list(entry.get("dims", (1,)))
    dims = (dims + [1, 1, 1, 1, 1])[:5]
    flops = max(entry.get("flops", 1.0), 1.0)
    byts = max(entry.get("bytes", 1.0), 1.0)
    return np.array([
        *[math.log1p(float(d)) for d in dims],
        math.log1p(flops),
        math.log1p(byts),
        math.log1p(flops / byts),
        1.0 if entry.get("dtype") in ("bf16", "f16") else 0.0,
    ])


class PredictionEngine:
    """Per-kind random forests trained from the profiling DB."""

    name = "prediction"
    priority = 20

    def __init__(self, hw: HardwareSpec, db: ProfileDB | None = None):
        self.hw = hw
        self.db = db or ProfileDB()
        self.models: dict[str, RandomForest] = {}
        self._trained = False
        self.state_version = 0   # bumped per (re)train; invalidates price caches

    def train(self, *, exclude_keys: set[str] | None = None, min_samples: int = 8):
        self.state_version += 1
        by_kind: dict[str, list[tuple[np.ndarray, float]]] = {}
        for key, entry in self.db.entries():
            if exclude_keys and key in exclude_keys:
                continue
            hwname, kind = key.split("|")[:2]
            if hwname != self.hw.name:
                continue
            by_kind.setdefault(kind, []).append(
                (entry_features(entry), math.log(max(entry["us"], 1e-3))))
        for kind, rows in by_kind.items():
            if len(rows) < min_samples:
                continue
            X = np.stack([r[0] for r in rows])
            y = np.array([r[1] for r in rows])
            self.models[kind] = RandomForest().fit(X, y)
        self._trained = True
        return self

    def supports(self, node: OpNode) -> bool:
        if not self._trained:
            self.train()
        return node.kind in self.models

    def latency_us(self, node: OpNode) -> float | None:
        if not self.supports(node):
            return None
        x = node_features(node)[None, :]
        return float(math.exp(self.models[node.kind].predict(x)[0]))
