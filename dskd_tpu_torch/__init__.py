"""dskd_tpu_torch: the PyTorch/CUDA port of dskd_tpu for NVIDIA Hopper.

Layout mirrors ``dskd_tpu/`` file for file; every module names the JAX module
and functions it ports. The JAX package stays the reference: this package
imports ``torch`` and never ``jax``. It reuses only the JAX package's modules
that import no JAX (``dskd_tpu/utils/config.py`` and the configuration
dataclasses and constants of ``dskd_tpu/data/pipeline.py``).

Two paths are ported: serving (``apis.inference.init_detector`` /
``inference_detector``) and the flagship incremental training step
(``train.step.make_train_step``: frozen teacher, student, merged-GT auction
matching, detection and distill losses, clipped AdamW). Both run
GFL-Deformable-DETR on the card, with the Pallas kernels of multi-scale
deformable attention, forward and backward, replaced by the CUDA kernels in
``csrc/``.
"""

__version__ = "0.1.0"
