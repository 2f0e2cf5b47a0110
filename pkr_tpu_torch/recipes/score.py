"""Standalone scoring CLI — the test.sh / test2.sh role.

Port of ``pkr_tpu/recipes/score.py`` over the port's ``run_score``; the
cosine products and the S-norm cohort statistics run on the card unless
``--device cpu`` is given.

    python -m pkr_tpu_torch.recipes.score --backend snorm \
        --enroll exp/test.iv --test exp/test.iv --cohort exp/train.iv \
        --trials data/test/trials --out exp/scores

Backends: cosine | snorm | plda | pool (test2.sh adds --datadir for pool's
spk2utt and plda's cohort utt2spk).  Prints EER and minDCF at the requested
p-targets (test.sh:65-75) and writes scores/results next to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None):
    from pkr_tpu_torch.config import Config, EvalConfig
    from pkr_tpu_torch.io import DataDir
    from pkr_tpu_torch.recipes.run import run_score

    ap = argparse.ArgumentParser(description="pkr_tpu_torch trial scoring")
    ap.add_argument("--backend", default="cosine",
                    choices=["cosine", "snorm", "plda", "pool"])
    ap.add_argument("--enroll", required=True, help="enroll embedding text-ark")
    ap.add_argument("--test", required=True, help="test embedding text-ark")
    ap.add_argument("--cohort", default=None, help="cohort/train embedding ark")
    ap.add_argument("--trials", required=True)
    ap.add_argument("--datadir", default=None,
                    help="data dir providing utt2spk/spk2utt (plda/pool)")
    ap.add_argument("--topk", type=int, default=300)
    ap.add_argument("--p-targets", type=float, nargs="+", default=[0.01, 0.001])
    ap.add_argument("--lda-dim", type=int, default=200)
    ap.add_argument("--out", default="exp/score")
    ap.add_argument("--device", default=None,
                    help="torch device of the products (default: the card)")
    args = ap.parse_args(argv)

    cfg = Config(eval=EvalConfig(backend=args.backend, topk=args.topk,
                                 p_targets=tuple(args.p_targets),
                                 lda_dim=args.lda_dim))
    cohort_u2s = None
    enroll_s2u = None
    if args.datadir:
        dd = DataDir.load(args.datadir, names=("utt2spk",)).make_spk2utt()
        cohort_u2s = dd.get("utt2spk")
        enroll_s2u = {s: v.split() for s, v in dd.get("spk2utt").items()}
    os.makedirs(args.out, exist_ok=True)
    res = run_score(cfg, args.out, args.trials, args.enroll, args.test,
                    cohort_ark=args.cohort, cohort_utt2spk=cohort_u2s,
                    enroll_spk2utt=enroll_s2u, device=args.device)
    print(json.dumps(res, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
