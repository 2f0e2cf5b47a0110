"""Recipe drivers of the port: config presets, corpus manifest builders, the
stage-gated CLI (``python -m pkr_tpu_torch.recipes.run``) and the scoring
and prep CLIs."""
