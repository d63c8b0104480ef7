"""dskd_tpu_torch: the PyTorch/CUDA port of dskd_tpu for NVIDIA Hopper.

Layout mirrors ``dskd_tpu/`` file for file; every module names the JAX module
and functions it ports. The JAX package stays the reference: this package
imports ``torch`` and never ``jax``, and nothing of the JAX package either.
It keeps its own copy of what it needs from it (``utils/config.py``, the
``PipelineConfig`` of ``data/pipeline.py``); ``utils.config.load_config``
reads the repository's config files without importing the JAX package.

Three paths are ported: serving (``apis.inference.init_detector`` /
``inference_detector``), the flagship incremental training step
(``train.step.make_train_step``: frozen teacher, student, merged-GT auction
matching, detection and distill losses, clipped AdamW) and the incremental
training loop around it (``train.incremental.run_incremental``, the
``tools.train_increment`` and ``tools.test`` CLIs: COCO task datasets, the
data loader, COCO bbox evaluation, task checkpoints). They run
GFL-Deformable-DETR on the card, with the Pallas kernels of multi-scale
deformable attention, forward and backward, replaced by the CUDA kernels in
``csrc/``: the default sampling path and the ``DSKD_WGATHER=0`` and
``DSKD_FUSED_ROWS`` variants (``ops/msda.py``).
"""

__version__ = "0.1.0"
