"""pkr_tpu_torch — the PyTorch/CUDA port of pkr_tpu for NVIDIA Hopper (H100).

It mirrors ``pkr_tpu``'s layout and function names so that each module has an
obvious counterpart, and it imports neither JAX nor anything of ``pkr_tpu``:

- ``pkr_tpu_torch.frontend``  wav → fbank → energy VAD → sliding CMVN →
                              voiced-frame selection, batched on the card
- ``pkr_tpu_torch.models``    ResNet and DenseNet trunks (reference
                              state-dict names) and the speaker model with
                              softmax/AAM heads
- ``pkr_tpu_torch.ops``       stats pooling, the dense AAM head and the
                              flash AAM head with its CUDA kernels
- ``pkr_tpu_torch.io``        Kaldi ark/scp (CM codec, native reader), wavs,
                              data directories
- ``pkr_tpu_torch.data``      samplers, host loaders, the card-resident
                              quantized feature cache, speed perturbation
- ``pkr_tpu_torch.train``     train state and SGD, the train and eval steps
                              (dense and flash heads; one process or a
                              mesh), the epoch loop, checkpoints with
                              resume and warm starts
- ``pkr_tpu_torch.eval``      extraction, cosine scoring, cohort S-norm,
                              LDA/PLDA, trial files, EER/minDCF
- ``pkr_tpu_torch.config``    the typed Config tree (JSON in and out)
- ``pkr_tpu_torch.recipes``   presets, corpus builders and the stage-gated
                              CLI ``python -m pkr_tpu_torch.recipes.run``
- ``pkr_tpu_torch.parallel``  process groups (one process a card), the
                              (data, model) mesh, the class-sharding rule,
                              the multi-rank dry run
- ``pkr_tpu_torch.utils``     training meters, progress logging, profiling,
                              the job runner and the multi-host launchers
- ``pkr_tpu_torch.convert``   flax variables (and a mid-training
                              ``TrainState``) → the port's state dict

Entry points take ``device=None``, meaning ``"cuda"``; they raise when no
card is present instead of falling back to the CPU.  Pass ``device="cpu"``
to run the plain PyTorch versions on the CPU.
"""

__version__ = "0.1.0"
