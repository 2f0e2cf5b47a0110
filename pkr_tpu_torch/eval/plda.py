"""LDA + PLDA backend — native replacement for the Kaldi C++ ivector tools.

A numpy copy of ``pkr_tpu/eval/plda.py`` for the port, which imports
nothing of ``pkr_tpu``: the same float64 host code, so both packages give
the same transforms and scores.

Replaces the binaries on the reference's PLDA path (run.sh:323-351, test.sh:
25-30; inventory SURVEY §2.6): ivector-mean, ivector-subtract-global-mean,
ivector-normalize-length, ivector-compute-lda, ivector-compute-plda and
ivector-plda-scoring.  Everything is closed-form / small-EM numpy — the
embedding dim is 256 and speaker count ~7k, so this is host-side math; the
O(trials) scoring is vectorized.

Model: the two-covariance PLDA (Ioffe, "Probabilistic Linear Discriminant
Analysis", the model Kaldi's plda.cc implements): x = μ + v + e with
v ~ N(0, Φb) (speaker) and e ~ N(0, Φw) (channel).  After simultaneous
diagonalization (Φw → I, Φb → diag ψ), the verification log-likelihood-ratio
for an enrollment mean ū over n utterances and a test vector t is evaluated
per dimension:

  LLR = log N(t; nψ/(nψ+1)·ū, 1 + ψ/(nψ+1)) − log N(t; 0, 1 + ψ)

Kaldi conventions preserved: length normalization scales to sqrt(dim) (not
unit norm), LDA projects to dim 200 (run.sh:331), global-mean subtraction
precedes everything.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def length_normalize(x: np.ndarray) -> np.ndarray:
    """Scale rows to norm sqrt(dim) (ivector-normalize-length semantics)."""
    x = np.asarray(x, np.float64)
    dim = x.shape[-1]
    norms = np.linalg.norm(x, axis=-1, keepdims=True)
    return x * (np.sqrt(dim) / np.maximum(norms, 1e-12))


@dataclass
class LdaTransform:
    matrix: np.ndarray  # (out_dim, in_dim)
    mean: np.ndarray  # (in_dim,)

    def apply(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x, np.float64) - self.mean) @ self.matrix.T


def compute_lda(vecs: Dict[str, np.ndarray], utt2spk: Dict[str, str],
                dim: int = 200, total_covariance_factor: float = 0.1,
                covariance_floor: float = 1.0e-6) -> LdaTransform:
    """Fisher LDA with within-class whitening — ivector-compute-lda's exact
    construction (ivector-compute-lda.cc, oracle-tested against a literal
    transcription in tests/kaldi_plda_oracle.py): whiten
    f·Σ_total + (1−f)·Σ_within via eig with eigenvalues floored at
    `covariance_floor`·λ_max, then rotate to diagonalize the between-class
    covariance, keeping the top `dim` directions.  Defaults match the
    binary's (run.sh:332 passes total-covariance-factor 0.0)."""
    keys = list(vecs)
    X = np.stack([vecs[k] for k in keys]).astype(np.float64)
    spk = [utt2spk[k] for k in keys]
    mean = X.mean(axis=0)
    Xc = X - mean

    by_spk: Dict[str, List[int]] = {}
    for i, s in enumerate(spk):
        by_spk.setdefault(s, []).append(i)

    d = X.shape[1]
    Sb = np.zeros((d, d))
    for s, idx in by_spk.items():
        mu = Xc[idx].mean(axis=0)
        Sb += len(idx) * np.outer(mu, mu)
    n = len(keys)
    St = Xc.T @ Xc / n  # total covariance
    Sb /= n  # between-class (n-weighted speaker means)
    Sw = St - Sb  # within = total − between (CovarianceStats convention)
    W = (total_covariance_factor * St
         + (1.0 - total_covariance_factor) * Sw)

    # whiten W: eig, floor at covariance_floor·λ_max, T = diag(λ^-½)·Uᵀ
    evals, evecs = np.linalg.eigh(W)
    order = np.argsort(evals)[::-1]
    evals, evecs = evals[order], evecs[:, order]
    evals = np.maximum(evals, covariance_floor * evals[0]) ** -0.5
    T = evals[:, None] * evecs.T
    # rotate to diagonalize the whitened between-class covariance
    Bw = T @ Sb @ T.T
    bvals, bvecs = np.linalg.eigh(Bw)
    order = np.argsort(bvals)[::-1]
    proj = bvecs[:, order].T[:dim] @ T  # (dim, d)
    return LdaTransform(matrix=proj, mean=mean)


@dataclass
class PldaModel:
    mean: np.ndarray  # (d,) training-set mean in input space
    transform: np.ndarray  # (d, d): diagonalizing transform (rows)
    psi: np.ndarray  # (d,) between-class variance in transformed space

    def transform_vec(self, x: np.ndarray,
                      num_examples: Optional[np.ndarray] = None,
                      simple_length_norm: bool = False) -> np.ndarray:
        """Center + rotate into the diagonalized space (within-covar = I).

        num_examples (per row) additionally applies Kaldi's
        Plda::TransformIvector normalization: each transformed vector is
        scaled by sqrt(dim / (x' diag(1/(psi + 1/n)) x)) — or, with
        simple_length_norm, by sqrt(dim)/||x|| — matching
        ivector-plda-scoring's simple-length-norm=false default."""
        t = (np.asarray(x, np.float64) - self.mean) @ self.transform.T
        if num_examples is None:
            return t
        d = t.shape[-1]
        if simple_length_norm:
            dot = np.maximum((t ** 2).sum(axis=-1), 1e-20)
        else:
            n = np.asarray(num_examples, np.float64).reshape(-1, 1)
            inv = 1.0 / (self.psi[None, :] + 1.0 / n)
            dot = np.maximum((inv * t ** 2).sum(axis=-1), 1e-20)
        return t * np.sqrt(d / dot)[..., None]


def train_plda(vecs: Dict[str, np.ndarray], utt2spk: Dict[str, str],
               n_iters: int = 10) -> PldaModel:
    """EM for the two-covariance model — ivector-compute-plda's exact
    estimator (plda.cc PldaEstimator; oracle-tested against a literal
    transcription in tests/kaldi_plda_oracle.py, covariances + ψ + scores).

    Kaldi conventions matched: both covariances initialize to identity
    (InitParameters), the global mean is the UNWEIGHTED AVERAGE OF CLASS
    MEANS (stats.sum_/class_weight_ — not the utterance mean; the two
    differ whenever speakers have unequal utterance counts), n_iters
    defaults to the binary's --num-em-iters=10, and the diagonalizing
    transform comes from the Cholesky factor of Φw (GetOutput).

    E-step: posterior of each speaker's latent mean given its utterances;
    M-step: re-estimate between/within covariances from the expected
    sufficient statistics (the vectorized update below accumulates the
    same per-class terms as GetStatsFromIntraClass + GetStatsFromClassMeans:
    within ← [Σ_cls scatter + n·((m−w)(m−w)ᵀ + Σ_post)]/N, between ←
    [Σ_cls (wwᵀ + Σ_post)]/K).
    """
    keys = list(vecs)
    X = np.stack([vecs[k] for k in keys]).astype(np.float64)
    spk = [utt2spk[k] for k in keys]
    d = X.shape[1]

    by_spk: Dict[str, np.ndarray] = {}
    for i, s in enumerate(spk):
        by_spk.setdefault(s, []).append(i)
    groups = [np.asarray(idx) for idx in by_spk.values()]
    # class-weighted global mean: the average of speaker means
    mean = np.stack([X[g].mean(axis=0) for g in groups]).mean(axis=0)
    Xc = X - mean

    phi_w = np.eye(d)
    phi_b = np.eye(d)
    for _ in range(n_iters):
        b_stats = np.zeros((d, d))
        w_stats = np.zeros((d, d))
        n_total = 0
        inv_w = np.linalg.inv(phi_w)
        inv_b = np.linalg.inv(phi_b)
        for g in groups:
            n = len(g)
            xs = Xc[g]
            xbar = xs.mean(axis=0)
            # posterior of v: precision = inv_b + n inv_w, mean = P^-1 n inv_w xbar
            prec = inv_b + n * inv_w
            cov_v = np.linalg.inv(prec)
            mu_v = cov_v @ (n * (inv_w @ xbar))
            b_stats += cov_v + np.outer(mu_v, mu_v)
            # E[(x - v)(x - v)^T] summed over the group's utterances
            r = xs - mu_v
            w_stats += r.T @ r + n * cov_v
            n_total += n
        phi_b = b_stats / len(groups)
        phi_w = w_stats / n_total

    # simultaneous diagonalization, GetOutput-style: transform1 = chol(Φw)⁻¹
    # whitens Φw; the eig basis of the whitened Φb then diagonalizes both:
    # T Φw Tᵀ = I, T Φb Tᵀ = diag(ψ)
    transform1 = np.linalg.inv(np.linalg.cholesky(phi_w))
    Bw = transform1 @ phi_b @ transform1.T
    bvals, bvecs = np.linalg.eigh(Bw)
    order = np.argsort(bvals)[::-1]
    T = bvecs[:, order].T @ transform1
    psi = np.maximum(bvals[order], 0.0)
    return PldaModel(mean=mean, transform=T, psi=psi)


def plda_scores(model: PldaModel, enroll: Dict[str, np.ndarray],
                test: Dict[str, np.ndarray],
                trials: Sequence[Tuple[str, str]],
                enroll_counts: Optional[Dict[str, int]] = None,
                simple_length_norm: bool = False) -> np.ndarray:
    """Vectorized LLR scoring (ivector-plda-scoring), n-utterance enrollment
    supported via enroll_counts.  Vectors get Kaldi's per-vector
    normalization factor (Plda::TransformIvector under the
    simple-length-norm=false default: scale by
    sqrt(dim / (x' diag(1/(psi+1/n)) x)), n=1 for test vectors)."""
    e_keys = list(enroll)
    t_keys = list(test)
    n = np.asarray([float((enroll_counts or {}).get(k, 1)) for k in e_keys])
    E = model.transform_vec(np.stack([enroll[k] for k in e_keys]),
                            num_examples=n,
                            simple_length_norm=simple_length_norm)
    Tv = model.transform_vec(np.stack([test[k] for k in t_keys]),
                             num_examples=np.ones(len(t_keys)),
                             simple_length_norm=simple_length_norm)

    psi = model.psi[None, :]  # (1, d)
    nn = n[:, None]
    # same-speaker branch: t ~ N(m_e, 1 + ψ/(nψ+1)), m_e = nψ/(nψ+1)·ū
    m_e = nn * psi / (nn * psi + 1.0) * E  # (Ne, d)
    v_same = 1.0 + psi / (nn * psi + 1.0)  # (Ne, d)
    v_diff = 1.0 + psi  # (1, d)

    e_idx = {k: i for i, k in enumerate(e_keys)}
    t_idx = {k: i for i, k in enumerate(t_keys)}
    rows = np.fromiter((e_idx[a] for a, _ in trials), np.int64, len(trials))
    cols = np.fromiter((t_idx[b] for _, b in trials), np.int64, len(trials))

    t_sel = Tv[cols]
    m_sel = m_e[rows]
    vs = v_same[rows]
    ll_same = -0.5 * (np.log(2 * np.pi * vs) + (t_sel - m_sel) ** 2 / vs).sum(axis=1)
    ll_diff = -0.5 * (np.log(2 * np.pi * v_diff) + t_sel ** 2 / v_diff).sum(axis=1)
    return ll_same - ll_diff
