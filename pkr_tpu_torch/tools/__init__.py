"""The repository's tools that exercise the system (``tools/``), on the port.

- ``bigspk``: the flash head trained through stage 3 (``recipes.run.run_train``)
  at 7325 and 500,000 synthetic speakers, with the steady ms/step of each
  (``python -m pkr_tpu_torch.tools.bigspk``);
- ``parity_e2e``: the end-to-end quality study, the two-phase recipe on a
  synthetic 512-speaker corpus scored against the banked EER and minDCF rows
  of ``docs/parity_rows.jsonl`` (``python -m pkr_tpu_torch.tools.parity_e2e``);
- ``corpus_rehearsal``: the recipe CLI's stages 0-6 and a flash stage 3,
  over ~100k synthetic utterances of 2,000 speakers, with each stage's
  time and peak device memory (``python -m
  pkr_tpu_torch.tools.corpus_rehearsal``);
- ``recipe_demo``: every stage through the Python API on a 48-speaker
  augmented corpus (``python -m pkr_tpu_torch.tools.recipe_demo``);
- ``bench_stage1``: stage 1's utterances/s clean, augmented and
  all-reverb, and over CM-encode workers (``python -m
  pkr_tpu_torch.tools.bench_stage1``);
- ``train_roofline``: the train step's device time by bucket against the
  least time each bucket's work could take on the card (``python -m
  pkr_tpu_torch.tools.train_roofline``; ``--no-measure`` needs no card).

Each runs on the card unless given ``device="cpu"`` (``--device cpu``).
"""
