"""The repository's tools that exercise the system (``tools/``), on the port.

- ``bigspk``: the flash head trained through stage 3 (``recipes.run.run_train``)
  at 7325 and 500,000 synthetic speakers, with the steady ms/step of each
  (``python -m pkr_tpu_torch.tools.bigspk``);
- ``parity_e2e``: the end-to-end quality study, the two-phase recipe on a
  synthetic 512-speaker corpus scored against the banked EER and minDCF rows
  of ``docs/parity_rows.jsonl`` (``python -m pkr_tpu_torch.tools.parity_e2e``).

Both run on the card unless given ``device="cpu"`` (``--device cpu``).
"""
