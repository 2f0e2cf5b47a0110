"""The port's embedding diagnostics (pkr_tpu_torch.eval.visualize) against
pkr_tpu.eval.visualize: both are numpy on the same inputs, so they must
agree exactly."""

import os
import sys

import numpy as np
import pytest

import pkr_tpu.eval.visualize as jv
import pkr_tpu_torch.eval.visualize as tv


def _vecs(seed=2, n_spk=4, per=8, dim=16):
    rng = np.random.default_rng(seed)
    vecs, utt2spk = {}, {}
    for s in range(n_spk):
        c = rng.standard_normal(dim) * 3
        for j in range(per):
            u = f"s{s}-u{j}"
            vecs[u] = (c + rng.standard_normal(dim) * 0.3).astype(np.float32)
            utt2spk[u] = f"s{s}"
    return vecs, utt2spk


def test_stats_and_projections_match_pkr_tpu():
    vecs, utt2spk = _vecs()
    vecs["s0-bad"] = np.full(16, np.nan, np.float32)
    stats = tv.embedding_stats(vecs)
    np.testing.assert_equal(stats, jv.embedding_stats(vecs))  # NaN equals NaN here
    assert stats["nan_or_inf"] == 16.0
    del vecs["s0-bad"]
    assert tv.embedding_stats(vecs) == jv.embedding_stats(vecs)
    mat = np.stack(list(vecs.values()))
    np.testing.assert_array_equal(tv.pca_project(mat, 3), jv.pca_project(mat, 3))
    np.testing.assert_array_equal(tv.tsne_project(mat, perplexity=5.0, n_iter=80, seed=1),
                                  jv.tsne_project(mat, perplexity=5.0, n_iter=80, seed=1))
    got = tv.speaker_embeddings(vecs, utt2spk, "s2")
    assert sorted(got) == sorted(jv.speaker_embeddings(vecs, utt2spk, "s2"))
    assert len(got) == 8


@pytest.mark.parametrize("method", ["pca", "tsne"])
def test_plot_embeddings(tmp_path, method):
    """A PNG of segment keys ('utt##0') and speakers, subsampled to
    max_points as pkr_tpu does; matplotlib is imported only for a plot."""
    vecs, utt2spk = _vecs()
    vecs.update({f"{u}##0": v for u, v in list(vecs.items())[:4]})
    vecs["unknown"] = np.zeros(16, np.float32)
    out = tv.plot_embeddings(vecs, utt2spk, str(tmp_path / "emb.png"), method=method,
                             max_points=30)
    assert out == str(tmp_path / "emb.png") and os.path.getsize(out) > 5000
    with pytest.raises(ValueError, match="method"):
        tv.plot_embeddings(vecs, utt2spk, str(tmp_path / "x.png"), method="umap")


def test_matplotlib_imported_only_for_a_plot():
    import subprocess

    code = ("import sys; import pkr_tpu_torch.eval.visualize as v; import numpy as np; "
            "v.embedding_stats({'a': np.ones(3)}); v.pca_project(np.eye(3)); "
            "assert 'matplotlib' not in sys.modules")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=repo))
    assert proc.returncode == 0, proc.stderr
