"""Embedding diagnostics: 2-D projections and range checks.

Port of ``pkr_tpu/eval/visualize.py`` (host numpy).  Covers the
reference's qualitative tools (SURVEY §2.7): local/visualize_spk_emb.py /
visualize_utt_emb.py (t-SNE scatter plots of embeddings colored by
speaker), local/check_spk_emb_range.py (value-range sanity) and
local/get_spk_emb.py (embedding export by speaker).

Dependencies are kept to numpy (+ matplotlib only when a plot file is
requested): the 2-D projection is PCA by default with a small exact t-SNE
available for parity with the reference's plots.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def embedding_stats(vecs: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Value-range report (check_spk_emb_range.py role)."""
    mat = np.stack(list(vecs.values())).astype(np.float64)
    norms = np.linalg.norm(mat, axis=1)
    return {
        "count": float(mat.shape[0]),
        "dim": float(mat.shape[1]),
        "min": float(mat.min()),
        "max": float(mat.max()),
        "mean_abs": float(np.abs(mat).mean()),
        "norm_mean": float(norms.mean()),
        "norm_std": float(norms.std()),
        "nan_or_inf": float((~np.isfinite(mat)).sum()),
    }


def pca_project(mat: np.ndarray, dim: int = 2) -> np.ndarray:
    x = mat - mat.mean(axis=0)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return x @ vt[:dim].T


def tsne_project(mat: np.ndarray, dim: int = 2, perplexity: float = 20.0,
                 n_iter: int = 300, seed: int = 0, lr: float = 100.0) -> np.ndarray:
    """Small exact t-SNE (O(n²); for the few-hundred-point diagnostic plots
    the reference made with sklearn)."""
    n = mat.shape[0]
    rng = np.random.default_rng(seed)
    x = mat - mat.mean(axis=0)
    sq = np.sum(x * x, axis=1)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), 0.0)

    # binary-search per-point bandwidths to hit the target perplexity
    target = np.log(perplexity)
    p = np.zeros((n, n))
    for i in range(n):
        lo, hi = 1e-10, 1e10
        beta = 1.0
        di = np.delete(d2[i], i)
        for _ in range(40):
            w = np.exp(-di * beta)
            s = w.sum() + 1e-12
            h = np.log(s) + beta * (di * w).sum() / s
            if h > target:
                lo = beta
                beta = beta * 2 if hi > 1e9 else (beta + hi) / 2
            else:
                hi = beta
                beta = (beta + lo) / 2
        w = np.exp(-np.delete(d2[i], i) * beta)
        row = np.insert(w / (w.sum() + 1e-12), i, 0.0)
        p[i] = row
    p = (p + p.T) / (2 * n)
    p = np.maximum(p, 1e-12)

    y = rng.standard_normal((n, dim)) * 1e-2
    gains = np.ones_like(y)
    vel = np.zeros_like(y)
    for it in range(n_iter):
        dy2 = np.square(y[:, None, :] - y[None, :, :]).sum(-1)
        q_num = 1.0 / (1.0 + dy2)
        np.fill_diagonal(q_num, 0.0)
        q = np.maximum(q_num / q_num.sum(), 1e-12)
        pq = (p * (4.0 if it < 50 else 1.0)) - q
        grad = 4.0 * ((pq * q_num)[:, :, None] * (y[:, None, :] - y[None, :, :])).sum(1)
        gains = np.where(np.sign(grad) != np.sign(vel), gains + 0.2, gains * 0.8)
        gains = np.maximum(gains, 0.01)
        vel = 0.8 * vel - lr * gains * grad
        y = y + vel
        y = y - y.mean(axis=0)
    return y


def plot_embeddings(vecs: Dict[str, np.ndarray], utt2spk: Dict[str, str],
                    out_path: str, method: str = "pca",
                    max_points: int = 500, seed: int = 0) -> Optional[str]:
    """Scatter of 2-D-projected embeddings colored by speaker
    (visualize_spk_emb.py role).  Returns the written path, or None if
    matplotlib is unavailable."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    if method not in ("tsne", "pca"):
        raise ValueError(f"method {method!r} not in ('tsne', 'pca')")
    # segment keys ('utt##0') or filtered dirs can lack a speaker mapping
    keys = [k for k in vecs if k in utt2spk or k.rsplit("##", 1)[0] in utt2spk]
    spk_of = {k: utt2spk.get(k, utt2spk.get(k.rsplit("##", 1)[0]))
              for k in keys}
    if len(keys) > max_points:
        rng = np.random.default_rng(seed)
        keys = [keys[i] for i in rng.choice(len(keys), max_points, replace=False)]
    mat = np.stack([vecs[k] for k in keys])
    proj = tsne_project(mat, seed=seed) if method == "tsne" else pca_project(mat)
    spks = sorted({spk_of[k] for k in keys})
    spk_idx = {s: i for i, s in enumerate(spks)}
    colors = [spk_idx[spk_of[k]] for k in keys]
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(proj[:, 0], proj[:, 1], c=colors, cmap="tab20", s=12)
    ax.set_title(f"{method.upper()} of {len(keys)} embeddings / {len(spks)} speakers")
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def speaker_embeddings(vecs: Dict[str, np.ndarray], utt2spk: Dict[str, str],
                       speaker: str) -> Dict[str, np.ndarray]:
    """All embeddings of one speaker (local/get_spk_emb.py role)."""
    return {u: v for u, v in vecs.items() if utt2spk.get(u) == speaker}
