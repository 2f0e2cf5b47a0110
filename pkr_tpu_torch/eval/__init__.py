"""Evaluation backend of the port: extraction, scoring (cosine, cohort
S-norm), trial files, LDA/PLDA, EER/minDCF.  ``eval/visualize.py`` is not
ported yet."""

from pkr_tpu_torch.eval.metrics import compute_error_rates, compute_eer, compute_min_dcf
from pkr_tpu_torch.eval.scoring import (
    adaptive_snorm,
    cohort_topk_stats,
    cosine_scores,
    global_mean,
    pooled_speaker_means,
    read_trials,
    speaker_means,
    write_scores,
)
from pkr_tpu_torch.eval.plda import (
    LdaTransform,
    PldaModel,
    compute_lda,
    length_normalize,
    plda_scores,
    train_plda,
)
from pkr_tpu_torch.eval.extract import extract_embeddings, make_embed_fn

__all__ = [
    "compute_error_rates",
    "compute_eer",
    "compute_min_dcf",
    "adaptive_snorm",
    "cohort_topk_stats",
    "cosine_scores",
    "global_mean",
    "pooled_speaker_means",
    "read_trials",
    "speaker_means",
    "write_scores",
    "LdaTransform",
    "PldaModel",
    "compute_lda",
    "length_normalize",
    "plda_scores",
    "train_plda",
    "extract_embeddings",
    "make_embed_fn",
]
